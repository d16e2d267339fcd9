"""The system's command-line entry points on the port, each run as
``python -m counterfactualworldmodels_tpu_torch.scripts.<name>``:

- ``extract_structure``: structure extraction with the Soft ChannelMAE
  (per-patch soft visibility optimised through the frozen model);
- ``make_shards``: videos, frame directories and arrays into CWMSHARD files
  (with IMU sidecars) for the trainers;
- ``fidelity_report``: how far the shared-prefix engine's rungs move the
  counterfactual videos, flows and end products from the exact model;
- ``demo_counterfactuals``: factual prediction, a counterfactual, motion
  maps, a covariance probe and movability, written as PNGs;
- ``gen_api_doc``: the port's public API as ``docs/API_torch.md``;
- the measurement entry points: ``bench`` (counterfactual simulations per
  second), ``bench_sweep``, ``latency_bench``, ``serve_latency``,
  ``loadgen``, ``bench_conjoined``, ``bench_train``, ``bench_loader`` and
  ``bench_attention``, over ``_bench_common``.

Each mirrors the JAX package's script of the same name (flags and JSON
keys), takes ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path) and imports neither PIL nor matplotlib at module level.
"""
