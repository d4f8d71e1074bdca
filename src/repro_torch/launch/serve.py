"""Serving launcher: batched prefill + greedy decode on a checkpoint, the
port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --reduced --batch 4 --prompt-len 32 --max-new 32 [--device cpu]

It runs on the card unless ``--device cpu`` asks for the host.  The
weights come from ``torch.Generator().manual_seed(seed)`` (the reference's
``PRNGKey(seed)`` gives others) or, with ``--checkpoint-dir``, from the
latest checkpoint there (either package's); the prompts from
``numpy.random.RandomState(seed)``, the reference's draw.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.base import torch_dtype
from repro_torch.kernels import resolve_device
from repro_torch.models import build_model
from repro_torch.serve.decode import ServeConfig, generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where to serve: the card (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    model = build_model(arch)
    params = model.init_params(torch.Generator().manual_seed(args.seed),
                               device=device)
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir)
        restored = ckpt.restore_latest({"params": params})
        if restored:
            _, tree, _ = restored
            params = tree["params"]
            print(f"[serve] restored checkpoint step {restored[0]}")

    rng = np.random.RandomState(args.seed)
    prompt = torch.from_numpy(rng.randint(
        1, arch.vocab_size, (args.batch, args.prompt_len)).astype(
            np.int32)).to(device)
    extras = {}
    compute = torch_dtype(arch.compute_dtype)
    for key, frontend in (("patches", "patch"), ("frames", "frame")):
        if arch.frontend == frontend:
            extras[key] = torch.from_numpy(
                rng.randn(args.batch, arch.n_frontend_tokens, arch.d_model)
                * 0.05).to(device=device, dtype=compute)

    max_seq = args.prompt_len + args.max_new
    t0 = time.time()
    out = generate(model, params, prompt, args.max_new, max_seq,
                   ServeConfig(), extras=extras)
    out_host = out.cpu().numpy()
    dt = time.time() - t0
    n_tok = args.batch * args.max_new
    print(f"[serve] generated {tuple(out.shape)} in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s incl. first-call set-up)")
    print("[serve] first sequence:", out_host[0][:16])
    return out


if __name__ == "__main__":
    main()
