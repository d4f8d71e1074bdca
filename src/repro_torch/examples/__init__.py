"""The port's examples: the counterparts of the JAX package's
``examples/``, module for module, each run with
``python -m repro_torch.examples.<name>`` and writing under
``results/torch/``.

Simulated devices (``runtime.simdev``), so they run on the host:
``schedule_dag``, ``program_compile``, ``async_pipeline`` and
``serve_blur_pipeline``.  On a real device, the card unless ``--device
cpu`` asks for the host (raising without a card otherwise):
``quickstart``, ``runtime_dispatch``, ``autotune_attention`` and
``train_100m``.

Each module's ``main(argv)`` returns what it printed, as data; the sizes
are module constants (the reference's), so a test can shrink them.
"""
