"""The port's CI scripts, run as modules (``python -m
repro_torch.scripts.<name>``): ``check_static`` (both static-analysis
planes), ``http_smoke``, ``chaos_smoke`` and ``trace_smoke`` (the serving
launcher driven from outside, in a subprocess). Each takes ``--device
cpu`` to run on the CPU; without it the launcher takes the card."""
