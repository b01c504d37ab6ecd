"""Launchers of the port's LM stack (``python -m
repro_torch.launch.lm_serve``, ``python -m repro_torch.launch.train``)
and the step factories they share (``steps``)."""
