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
  Chrome trace exports and SLO logs.

Every tool runs on the card unless the caller asks for the CPU (``--cpu``
where the JAX script has the flag, ``SAT_TORCH_DEVICE=cpu`` always);
without a card and without that request it raises.  Importing a tool
loads nothing heavy: torch and the model code come in inside ``main``.
"""
