"""The port's serve surface at every default, the encode/decode tier
handoff and the plane flags of the CLI, held to sat_tpu on the CPU:
both servers on one small float32 checkpoint answer the admin, encode
and quality endpoints alike (C11), a grid framed by either package is
the same bytes and decodes in the other, and an /encode frame captions
on a decode tier with the words the image gets itself."""

import json

import numpy as np
import pytest
import torch

from sat_tpu_torch.serve import handoff
from tests.torch_planes_helpers import (
    boot, both_servers, caption, get_json, http, jax_engine, port_engine, registries, words, world,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def planes(tmp_path_factory):
    return world(tmp_path_factory.mktemp("serve_planes"))


def _surface(port, jpeg):
    """(status, key set or content type) of each request the C11 table
    names, at the defaults."""
    out = {}
    for verb in ("reload", "promote", "rollback"):
        status, _, raw = http(port, "POST", f"/{verb}")
        out[verb] = (status, sorted(json.loads(raw)))
    status, hdrs, raw = http(port, "POST", "/encode", jpeg, {"Content-Type": "image/jpeg"})
    grid, header = handoff.decode_grid(raw)
    out["encode"] = (status, hdrs["Content-Type"], grid.shape, str(grid.dtype), sorted(header))
    status, _, raw = http(port, "GET", "/quality_reference")
    out["quality_reference"] = (status, json.loads(raw))
    status, hz = get_json(port, "/healthz")
    out["healthz"] = (status, "lifecycle_state" in hz, hz["lifecycle_state"])
    status, stats = get_json(port, "/stats")
    out["stats"] = (status, sorted(stats["lifecycle"]))
    return out


def test_default_surface_matches_jax(planes):
    """C11: at the default config the port answers /reload, /promote,
    /rollback, /encode and /quality_reference as sat_tpu does, and its
    /healthz and /stats carry ``lifecycle_state`` and ``lifecycle``."""
    with both_servers(planes["jc"], planes["tc"]) as servers:
        got = {name: _surface(server.port, planes["jpegs"][0]) for name, server in servers.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"]["reload"][0] == 409 and got["torch"]["promote"][0] == 409
    assert got["torch"]["quality_reference"] == (404, {"error": "quality plane off; boot with --serve_quality on"})
    assert got["torch"]["encode"][:2] == (200, handoff.GRID_CONTENT_TYPE)
    assert got["torch"]["healthz"] == (200, True, "IDLE")


def test_handoff_frames_are_the_same_bytes_and_cross():
    """A grid framed by either package is byte-identical, and each decodes
    the other's frame to the same array and header."""
    from sat_tpu.serve import handoff as jax_handoff

    grid = np.random.default_rng(3).standard_normal((196, 512)).astype(np.float32)
    for step in (None, 7):
        ours, theirs = handoff.encode_grid(grid, step=step), jax_handoff.encode_grid(grid, step=step)
        assert ours == theirs
        for decode, frame in ((handoff.decode_grid, theirs), (jax_handoff.decode_grid, ours)):
            back, header = decode(frame)
            np.testing.assert_array_equal(back, grid)
            assert header.get("step") == step
    bad = bytearray(ours)
    bad[-1] ^= 1
    for pkg in (handoff, jax_handoff):
        with pytest.raises(pkg.HandoffError, match="crc32c"):
            pkg.decode_grid(bytes(bad))


@pytest.mark.parametrize("mode", ["batch", "continuous"])
def test_encode_tier_frame_captions_on_the_decode_tier(planes, tmp_path, mode):
    """An encode-tier server (warmed before ready) frames the grid; a
    decode-tier server in ``mode`` captions it with the words it gives
    the image itself, and with sat_tpu's decode tier's words for the same
    frame; a flipped bit is 400, a grid of another step 409, a grid of
    another shape 400."""
    enc_cfg = planes["tc"].replace(serve_tier="encode", telemetry_dir=str(tmp_path / "enc"))
    dec_cfg = planes["tc"].replace(serve_tier="decode", serve_mode=mode, telemetry_dir=str(tmp_path / "dec"))
    jdec_cfg = planes["jc"].replace(serve_tier="decode", serve_mode=mode, telemetry_dir=str(tmp_path / "jdec"))
    with registries():
        enc_engine = port_engine(enc_cfg)
        enc = boot("torch", enc_cfg, enc_engine)
        dec = boot("torch", dec_cfg, port_engine(dec_cfg))
        jdec = boot("jax", jdec_cfg, jax_engine(jdec_cfg))
        try:
            assert enc_engine._enc_one_warm and get_json(enc.port, "/healthz")[1]["tier"] == "encode"
            grid_hdr = {"Content-Type": handoff.GRID_CONTENT_TYPE}
            for body in planes["jpegs"][:3]:
                status, hdrs, frame = http(enc.port, "POST", "/encode", body, {"Content-Type": "image/jpeg"})
                assert status == 200 and hdrs["Content-Type"] == handoff.GRID_CONTENT_TYPE
                replies = {}
                for name, port in (("torch", dec.port), ("jax", jdec.port)):
                    status, _, raw = http(port, "POST", "/caption", frame, grid_hdr)
                    assert status == 200, raw
                    replies[name] = json.loads(raw)
                status, own, _ = caption(dec.port, body)
                assert status == 200
                assert words(replies["torch"]) == words(own) == words(replies["jax"])
            bad = bytearray(frame)
            bad[-3] ^= 0x40
            assert http(dec.port, "POST", "/caption", bytes(bad), grid_hdr)[0] == 400
            grid, header = handoff.decode_grid(frame)
            stale = handoff.encode_grid(grid, step=header["step"] + 1)
            assert http(dec.port, "POST", "/caption", stale, grid_hdr)[0] == 409
            assert http(jdec.port, "POST", "/caption", stale, grid_hdr)[0] == 409
            wrong = handoff.encode_grid(grid[:-1], step=header["step"])
            status, _, raw = http(dec.port, "POST", "/caption", wrong, grid_hdr)
            assert status == 400 and b"aval mismatch" in raw
            counters = get_json(dec.port, "/stats")[1]["counters"]
            assert counters["serve/grid_requests"] >= 3 and counters["serve/bad_handoff"] == 2
            assert counters["serve/stale_handoff"] == 1
        finally:
            for server in (enc, dec, jdec):
                server.shutdown()


PLANE_FLAGS = ["--tenants", "a:2:5,b:1", "--encode_cache", "on", "--encode_cache_mb", "16",
               "--serve_tier", "decode", "--serve_quality", "on", "--quality_reference", "/tmp/ref.json",
               "--slo_quality_psi", "0.25", "--slo_quality_unk", "0.1", "--model_reload", "2.5",
               "--canary_fraction", "0.3", "--canary_window_s", "12", "--promote_policy", "manual"]
PLANE_FIELDS = ("tenants", "encode_cache", "encode_cache_mb", "serve_tier", "serve_quality",
                "serve_quality_reference", "slo_quality_psi", "slo_quality_unk", "model_reload",
                "canary_fraction", "canary_window_s", "promote_policy")


def test_cli_takes_the_plane_flags_as_jax_does(capsys):
    """The plane flags of sat_tpu's CLI, with the same names, choices and
    defaults: the same Config fields from one argv, and each flag in both
    ``--help`` listings."""
    import re

    from sat_tpu.cli import build_config as jax_build
    from sat_tpu_torch.cli import build_config

    argv = ["--phase", "serve", *PLANE_FLAGS]
    config, _ = build_config(argv)
    jax_config = jax_build(argv)[0]
    assert {f: getattr(config, f) for f in PLANE_FIELDS} == {f: getattr(jax_config, f) for f in PLANE_FIELDS}
    defaults = build_config(["--phase", "serve"])[0]
    assert {f: getattr(defaults, f) for f in PLANE_FIELDS} == {
        f: getattr(jax_build(["--phase", "serve"])[0], f) for f in PLANE_FIELDS}
    listings = {}
    for name, build in (("torch", build_config), ("jax", jax_build)):
        with pytest.raises(SystemExit):
            build(["--help"])
        listings[name] = set(re.findall(r"(--[a-z_0-9]+)", capsys.readouterr().out))
    flags = set(PLANE_FLAGS[::2])
    assert flags <= listings["torch"] and flags <= listings["jax"]
