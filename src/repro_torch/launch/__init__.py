"""Launchers and the launch analysis stack: the port of ``repro.launch``
(``serve``, ``train``, ``mesh``, ``hlo_analysis``, ``roofline``,
``dryrun``, ``profile``)."""
