"""sat_tpu_torch.tools — the evidence and operator tools, the port of
``scripts/``.

Each tool runs as ``python -m sat_tpu_torch.tools.<name>`` and keeps the
file name, flags and exit codes of ``scripts/<name>.py``:

* :mod:`.quality_run` — train → checkpoint → beam eval → scores on the
  procedural corpus of :mod:`.corpus`; :mod:`.continue_quality_run`
  extends a finished run; :mod:`.import_finetune_run` exports a trained
  model to the reference's flat npy, imports it into a fresh model and
  finetunes it against a from-scratch control;
* :mod:`.export_reference` and :mod:`.trim_model` — command lines over
  ``train.checkpoint``'s export and trim;
* :mod:`.replay_exemplar` — replays a quality-plane exemplar through a
  freshly booted engine in the geometry it was captured in;
* :mod:`.merge_traces` and :mod:`.check_slo` — the operator's tools over
  Chrome trace exports and SLO logs; :mod:`.analyze_postmortem` — the
  summary of a flight recorder's postmortem bundle;
* :mod:`.chaos_campaign` — the fault matrix, each scenario a real CLI run
  or a serve stack in a child process on the fixture of :mod:`.fixtures`;
* :mod:`.vocab5000_run` — training and beam eval at V=5000 in one process
  against a (2,4) vocab-parallel mesh, whose ranks run the CLI through
  :mod:`.cli_ranks`;
* the measurement vehicles, one for each ``scripts/bench_*.py`` with its
  metric names (:mod:`.bench_attend` for ``bench_pallas``): the kernel,
  eval, eval A/B, early-exit, serve, bulk, diag and quality vehicles on
  the card, and seven host-only ones (input, telemetry, obs, fleet,
  watchdog, integrity, ckpt), over :mod:`.benchlib` and
  ``utils.benchmarking``; :mod:`.check_regression` gates their rows and
  the compile reports.

Every tool runs on the card unless the caller asks for the CPU (``--cpu``
on the quality tools, the chaos campaign, the V=5000 run and the
vehicles whose JAX script has it, ``SAT_TORCH_DEVICE=cpu`` on any tool);
without a card and without that request it raises (a vehicle exits 1
with the reason).  Importing a tool
loads nothing heavy: torch and the model code come in inside ``main``.
"""
