"""``python -m sat_tpu_torch.tools.bench_serve`` on the CPU
(``SAT_TORCH_DEVICE=cpu``) at the small model's widths, in each of its
modes: the rows ``scripts/bench_serve.py`` prints in that mode (the same
metrics in the same order, the same units, read from the JAX script's
source), finite values, the device named, the kernel launch counts of
each phase, and exit 0 (every mode's invariants held: no kernel build
under load, no dropped request, the cache's parity and ratios)."""

import pytest

from tests.torch_bench_helpers import SMALL, extra, finite, jax_pairs, rows, run_tool

PAIRS = dict(jax_pairs("bench_serve.py", quant_ab="bf16"))
SERVE = extra(SMALL + ["beam_size=2"]) + ["--slot-pages", "2", "--page-width", "2"]

MODES = {
    "single_server": (
        ["--concurrency", "2", "--requests", "3", "--open-requests", "8", "--rate", "20", "--cont-rate", "20",
         "--quant-ab", "bf16"],
        ["serve_closed_loop_throughput", "serve_open_loop_p99_latency_ms", "serve_encode_ms",
         "serve_continuous_goodput", "serve_admission_latency_ms", "serve_single_stream_latency_ms",
         "serve_encode_ms_bf16", "serve_closed_loop_throughput_bf16"],
    ),
    "fleet": (
        ["--fleet", "--fleet-sizes", "1,2", "--fleet-requests", "4", "--fleet-rate", "10",
         "--fleet-service-floor-ms", "100"],
        ["fleet_goodput_rps", "fleet_open_loop_p99_latency_ms", "fleet_disagg_goodput_rps",
         "fleet_router_overhead_ms"],
    ),
    "tenants": (
        ["--tenants", "--tenant-requests", "6", "--tenant-rate", "10", "--tenant-flood-rate", "20",
         "--tenant-concurrency", "2", "--tenant-share-seconds", "2"],
        ["tenant_isolation_p99_ratio", "tenant_fair_share_error"],
    ),
    "metering": (
        ["--metering", "--metering-requests", "6", "--metering-rate", "10"],
        ["metering_overhead_pct", "encode_cache_would_hit_ratio"],
    ),
    "encode_cache": (
        ["--encode-cache", "--cache-requests", "40", "--cache-rate", "20"],
        ["encode_cache_hit_ratio", "cache_serve_goodput_rps"],
    ),
    "lifecycle": (
        ["--lifecycle", "--lifecycle-requests", "6", "--lifecycle-rate", "10"],
        ["swap_blackout_ms", "canary_overhead_pct"],
    ),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bench_serve_mode_rows_match_the_jax_script(mode, tmp_path):
    flags, metrics = MODES[mode]
    proc = run_tool("bench_serve", [*SERVE, *flags, "--workdir", str(tmp_path)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = rows(proc.stdout)
    assert [r["metric"] for r in got] == metrics
    for r in got:
        assert r["unit"] == PAIRS[r["metric"]], r["metric"]
        assert finite(r) and r["device_kind"] == "cpu" and r["schema_version"] == 1
        assert r.get("steady_state_compiles", 0) == 0
    if mode == "single_server":
        # the CPU runs the plain attention: no kernel launch, counted all the same
        assert all(r["fused_attend_launches"] == 0 for r in got)
        assert all(r["fused_attend_masked_launches"] == 0 for r in got[3:6])
    elif mode == "fleet":
        assert set(got[0]["replica_launches"]) == {"r0", "r1"}
        assert all(v == 0 for r in got for v in r["per_replica_recompiles"].values())
    else:
        assert all(r["fused_attend_masked_launches"] == 0 for r in got)
