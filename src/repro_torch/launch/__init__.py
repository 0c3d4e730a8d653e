"""Launch: the production training launcher (``python -m repro_torch.launch.train``),
the mesh builders, the dry-run cell specs and dry run on the meta device
(``python -m repro_torch.launch.dryrun``), the analytic cost model and FLOP
counter, and the H100 roofline with the collective-bytes meter."""
