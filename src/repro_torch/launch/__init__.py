"""Launchers of the port's LM stack (``python -m
repro_torch.launch.lm_serve``, ``python -m repro_torch.launch.train``,
``python -m repro_torch.launch.dryrun``, ``python -m
repro_torch.launch.probe_buffers``), the step factories they share
(``steps``), and the multi-device layer (``mesh``, ``partition``)."""
