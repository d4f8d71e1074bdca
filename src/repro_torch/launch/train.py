"""Training launcher: checkpointed, preemption-safe, straggler-monitored —
the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
        --reduced --steps 50 --checkpoint-dir /tmp/ckpt \\
        --checkpoint-every 20 [--device cpu]

It trains on the card unless ``--device cpu`` asks for the host.  The
weights come from ``torch.Generator().manual_seed(seed)`` (the reference's
``PRNGKey(seed)`` gives others); the data are the reference's
(``data.pipeline``).  Fault tolerance, as the reference's:
  * atomic checkpoints (params + optimizer + data cursor) every N steps,
    under the reference's keys, so either package resumes the other's;
  * auto-resume from the latest valid checkpoint (restart-safe);
  * SIGTERM/SIGINT -> checkpoint-and-exit(143) (preemption handling);
  * ``--fail-at-step`` injects a crash (exit 42);
  * per-step wall-time straggler monitor: steps slower than
    ``straggler_factor x`` the running median are logged and counted;
  * optional int8 error-feedback gradient compression (--compress-grads).
The step updates params and optimizer state in place, where the reference
donates them to its jitted step.

``--data-parallel`` joins a process group (``dist.compat``: ``torchrun``'s
environment, ``--dist-init URL`` with ``RANK``/``WORLD_SIZE``, or a world of
one when started plainly, as ``jax.device_count()`` is one on one card),
builds a 1-D ``("data",)`` mesh over it with ``train_rules()`` and runs each
step under it: every rank makes the same params (their fingerprints are
checked equal across ranks) and draws the same global batch, takes its
block, and the token-weighted gradients are summed over ``data`` before
AdamW (``train.step``).  Rank 0 alone writes checkpoints, ``--metrics-out``
and the log.  The backend is NCCL on the card and gloo on the CPU unless
``--dist-backend`` says otherwise (gloo for ranks sharing one card, its
CUDA tensors staged through host memory).

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch yi-9b --reduced --data-parallel --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, DataState, Pipeline
from repro_torch.dist import collectives, compat
from repro_torch.dist.sharding import train_rules, use_mesh
from repro_torch.kernels import resolve_device
from repro_torch.models import build_model
from repro_torch.models.module import leaves
from repro_torch.optim import compression as comp_mod
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.step import TrainStepConfig, make_train_step


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 3.0
    times: list = dataclasses.field(default_factory=list)
    slow_steps: int = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        hist = sorted(self.times[-50:])
        median = hist[len(hist) // 2]
        slow = len(self.times) > 5 and dt > self.factor * median
        if slow:
            self.slow_steps += 1
        return slow


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the family-preserving smoke config (CPU)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--fail-at-step", type=int, default=-1,
                    help="failure injection: crash at this step")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--data-parallel", action="store_true",
                    help="shard the batch over the process group's ranks "
                         "(1-D 'data' mesh + train_rules)")
    ap.add_argument("--async-checkpoint", action="store_true",
                    help="serialize checkpoints on a background thread")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where to train: the card (default) or cpu")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="--data-parallel's backend (default: nccl on the "
                         "card, gloo on the cpu)")
    ap.add_argument("--dist-init", default=None,
                    help="--data-parallel's rendezvous URL (e.g. file://...,"
                         " with RANK and WORLD_SIZE set); default torchrun's "
                         "environment, or a world of one")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if not args.data_parallel:
        return _train(args, device, None)
    with compat.process_group(device, backend=args.dist_backend,
                              init_method=args.dist_init) as device:
        mesh = compat.make_mesh((dist.get_world_size(),), ("data",),
                                device=device)
        return _train(args, device, mesh)


def _same_on_every_rank(params) -> None:
    """Raise unless every rank made bit-equal params."""
    prints = [collectives.fingerprint(p) for p in leaves(params)]
    if any(other != prints for other in collectives.all_ranks(prints)):
        raise RuntimeError("--data-parallel: the ranks' initial params "
                           "differ")


def _train(args, device, mesh):
    """The training loop; ``mesh`` is the data-parallel mesh or None."""
    writer = mesh is None or dist.get_rank() == 0
    log = print if writer else (lambda *a, **kw: None)
    arch = get_arch(args.arch)
    if args.reduced:
        arch = arch.reduced()
    model = build_model(arch)
    step_cfg = TrainStepConfig(microbatches=args.microbatches,
                               grad_compression=args.compress_grads,
                               ce_seq_chunk=min(512, args.seq_len))
    optimizer = AdamW(learning_rate=warmup_cosine(args.lr, args.warmup,
                                                  args.steps))
    base_step = make_train_step(model, optimizer, step_cfg)
    if mesh is not None:
        rules = train_rules()

        def train_step(*step_args):
            with use_mesh(mesh, rules):
                return base_step(*step_args)
    else:
        train_step = base_step

    params = model.init_params(torch.Generator().manual_seed(args.seed),
                               device=device)
    if mesh is not None:
        _same_on_every_rank(params)
    opt_state = optimizer.init(params)
    comp_state = comp_mod.init(params) if args.compress_grads else None
    data_cfg = DataConfig(vocab_size=arch.vocab_size, seq_len=args.seq_len,
                          global_batch=args.batch, seed=args.seed)
    pipeline = Pipeline(
        data_cfg,
        frontend=arch.frontend,
        n_frontend_tokens=arch.n_frontend_tokens,
        d_model=arch.d_model,
        device=device)

    start_step = 0
    ckpt = None
    if args.checkpoint_dir:
        ckpt = CheckpointManager(args.checkpoint_dir)
        if args.resume:
            restored = ckpt.restore_latest({"params": params,
                                            "opt": opt_state})
            if restored is not None:
                step, tree, extra = restored
                params, opt_state = tree["params"], tree["opt"]
                pipeline.state = DataState.from_dict(extra["data"])
                start_step = step
                log(f"[train] resumed from step {step}")

    def save(step):
        if ckpt is None or not writer:
            return
        tree = {"params": params, "opt": opt_state}
        extra = {"data": pipeline.state.to_dict(), "arch": arch.name}
        if args.async_checkpoint:
            ckpt.save_async(step, tree, extra=extra)
        else:
            ckpt.save(step, tree, extra=extra)
        log(f"[train] checkpoint @ step {step}")

    interrupted = {"flag": False}

    def on_term(signum, frame):
        interrupted["flag"] = True

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)

    monitor = StragglerMonitor()
    metrics_log = []
    for step in range(start_step, args.steps):
        if step == args.fail_at_step:
            print(f"[train] INJECTED FAILURE at step {step}", flush=True)
            os._exit(42)
        batch = pipeline.next_batch()
        t0 = time.time()
        if args.compress_grads:
            params, opt_state, comp_state, metrics = train_step(
                params, opt_state, batch, comp_state)
        else:
            params, opt_state, metrics = train_step(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        slow = monitor.record(dt)
        metrics.update(step=step + 1, step_time_s=dt, slow=bool(slow))
        metrics_log.append(metrics)
        if slow:
            log(f"[train] STRAGGLER step {step+1}: {dt:.2f}s "
                f"(x{monitor.factor} median)")
        if (step + 1) % 10 == 0 or step == start_step:
            log(f"[train] step {step+1}/{args.steps} "
                f"loss={metrics['loss']:.4f} ce={metrics['ce']:.4f} "
                f"gnorm={metrics['grad_norm']:.2f} {dt:.2f}s")
        if ckpt and (step + 1) % args.checkpoint_every == 0:
            save(step + 1)
        if interrupted["flag"]:
            log("[train] preemption signal: checkpointing and exiting")
            save(step + 1)
            sys.exit(143)
    save(args.steps)
    if ckpt is not None:
        ckpt.wait()
    if args.metrics_out and writer:
        with open(args.metrics_out, "w") as f:
            json.dump(metrics_log, f)
    log(f"[train] done: final loss {metrics_log[-1]['loss']:.4f}, "
        f"straggler steps: {monitor.slow_steps}")
    return metrics_log


if __name__ == "__main__":
    main()
