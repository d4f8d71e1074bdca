"""The paper's own experiments on the port: the counterparts of the JAX
package's scripts under ``benchmarks/``.

- ``tables``: Tables 4–8, NN+C and four baselines per kernel-variant-
  hardware combo (the reference's simulated and host combos, and the card
  combos the port measures on a CUDA device);
- ``unconstrained``: Table 9 / Fig. 3, lightweight against unconstrained;
- ``omitted_kernels``: the Cholesky/QR appendix;
- ``variant_selection``: Fig. 4, blur schedule selection;
- ``runtime_overhead``: dispatch overhead and selection against the
  oracle on the blur axis;
- ``executor_overlap``: sequential against async on simulated devices;
- ``__main__``: ``python -m repro_torch.paper [--quick|--full]
  [--device cuda|cpu]``, the counterpart of ``benchmarks/run.py``.

Each ``run`` resumes from or writes its ``out_path`` (default under
``results/torch/``, apart from the JAX package's results) and reads and
writes generated datasets under ``results/perfdata/``, shared with the
JAX package.
"""
