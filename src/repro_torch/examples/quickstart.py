"""Quickstart: the whole pitch in five lines — the port of
``examples/quickstart.py``.

    from repro_torch.api import ops, trace
    with trace() as tb:
        out = ops.blur(ops.matmul(a, b))   # lazy op graph — nothing runs
    compiled = tb.compile()                # schedule from predicted times
    result = compiled()                    # predicted-best variant per node

Demo 1 runs exactly that flow on the device (the card unless ``--device
cpu``) against its own tuning cache under ``results/torch/tunecache``: a
few eager warm-up calls cold-measure the variants (on the card the hand
matmul kernels among them) and fit the NN+C models, then the traced graph
compiles and executes prediction-only.  Demo 2 is the paper's offline
predictor study (NN+C on a kernel/variant/hardware combo, ~13% MAPE
regime).  Demo 3 trains reduced gemma3-1b through the production train
step on the device; its head dim (16) is one the hand attention kernel
lacks, so its attention runs the plain ``attend_chunked``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import os

import numpy as np
import torch

from repro_torch.core.nnc import make_model, mape, slice_features
from repro_torch.kernels import resolve_device
from repro_torch.perfdata.datasets import Combo, generate, train_test_split

CACHE_ROOT = "results/torch/tunecache"
NNC_EPOCHS = 12000
LM_STEPS = 5


def api_demo(device) -> dict:
    print("== 1. repro_torch.api: trace -> compile -> run ==")
    from repro_torch.api import ops, trace, use_dispatcher
    from repro_torch.runtime import (Dispatcher, DispatchPolicy, TuningCache,
                                     current_fingerprint)

    disp = Dispatcher(
        cache=TuningCache(root=CACHE_ROOT,
                          fingerprint=current_fingerprint(device)),
        policy=DispatchPolicy(min_rows_to_fit=6, fit_epochs=1500,
                              min_window=1e-3))
    rng = np.random.RandomState(0)

    def draw(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(
            device)

    a, b = draw(96, 80), draw(80, 64)
    with use_dispatcher(disp):
        # eager calls are the same API — here they warm the tuning cache
        # (cold path measures variants, then the lightweight model fits)
        for m, n, k in [(64, 64, 64), (96, 80, 64), (128, 96, 80)]:
            ops.matmul(draw(m, k), draw(k, n))
        for m, n in [(96, 96), (128, 96), (94, 62)]:
            ops.blur(draw(m, n))

        with trace() as tb:
            out = ops.blur(ops.matmul(a, b))
        compiled = tb.compile()
        result = compiled()

    ref = a @ b
    ref = (sum(ref[i:ref.shape[0] - 2 + i, j:ref.shape[1] - 2 + j]
               for i in range(3) for j in range(3)) / 9.0)
    err = float((result - ref).abs().max())
    print(f"traced program: {[n.name for n in tb.program.nodes]}, "
          f"predicted makespan {compiled.makespan*1e3:.3f}ms")
    picks = [(sel.kernel, sel.chosen, sel.mode)
             for sel in list(disp.selections)[-2:]]
    for kernel, chosen, mode in picks:
        print(f"  {kernel:8s} -> {chosen} ({mode})")
    print(f"max|api - reference| = {err:.2e} (out {tuple(out.shape)}, "
          f"on {result.device})")
    assert err < 1e-4 and result.device == torch.device(device)
    return {"picks": picks, "err": err, "makespan_s": compiled.makespan}


def nnc_demo() -> dict:
    print("\n== 2. NN+C performance prediction (mv / eigen / i7) ==")
    combo = Combo("mv", "eigen", "i7", simulated=True)
    X, y, names = generate(combo, n=500, seed=0, cache_dir=None)
    (trX, trY), (teX, teY) = train_test_split(X, y)
    model, uses_c = make_model("nnc", X.shape[1], epochs=NNC_EPOCHS)
    model.fit(slice_features(trX, uses_c), trY)
    pred = model.predict(slice_features(teX, uses_c))
    print(f"features: {names}")
    print(f"NN+C ({model.n_params} params): test MAPE "
          f"{mape(teY, pred):.1f}%  (paper regime: ~13%)")
    return {"n_params": model.n_params, "mape": float(mape(teY, pred))}


def lm_demo(device) -> dict:
    print("\n== 3. Reduced gemma3-1b through the production train step ==")
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import TrainStepConfig, make_train_step

    cfg = get_arch("gemma3-1b").reduced()
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0),
                               device=device)
    opt = AdamW(learning_rate=1e-3)
    opt_state = opt.init(params)
    step = make_train_step(model, opt, TrainStepConfig(ce_seq_chunk=32),
                           use_kernel=False)
    pipe = Pipeline(DataConfig(cfg.vocab_size, seq_len=64, global_batch=4),
                    device=device)
    losses = []
    for i in range(LM_STEPS):
        params, opt_state, metrics = step(params, opt_state,
                                          pipe.next_batch())
        losses.append(float(metrics["loss"]))
        print(f"step {i+1}: loss={losses[-1]:.4f}")
    return {"losses": losses}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(CACHE_ROOT, exist_ok=True)
    return {"api": api_demo(device), "nnc": nnc_demo(),
            "lm": lm_demo(device)}


if __name__ == "__main__":
    main()
