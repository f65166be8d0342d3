"""The survey layer of the port (mirrors pypulsar_tpu/survey): the
per-observation stage chain (``dag``), batch lanes (``lane``), and the
fleet runtime for one host (``scheduler``'s ``FleetScheduler``,
``state``'s manifests, status views and traces, ``fleet``'s plane
directory), surfaced as ``python -m pypulsar_tpu_torch.cli survey``."""
