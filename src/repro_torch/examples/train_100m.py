"""End-to-end driver: train a ~100M-param dense LM through the full
production stack (data pipeline -> train step -> checkpointing ->
metrics) — the port of ``examples/train_100m.py``, on the device (the card
unless ``--device cpu``).

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 10   # smoke

Checkpoints go to ``results/torch/train_100m_ckpt`` (a rerun resumes from
them, as the launcher does) and the metrics to
``results/torch/train_100m_metrics.json``.
"""
import argparse
import dataclasses
import os

from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import train as train_launcher

METRICS = "results/torch/train_100m_metrics.json"


def model_100m() -> ArchConfig:
    # yi-9b family shrunk to ~100M params: 12L, d=768, tied 32k vocab
    base = get_arch("yi-9b")
    return dataclasses.replace(
        base, name="yi-100m", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32000,
        tie_embeddings=True)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "train_100m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--checkpoint-dir",
                    default="results/torch/train_100m_ckpt")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or cpu")
    args = ap.parse_args(argv)

    cfg = model_100m()
    from repro_torch.models import build_model, module
    n = module.count_params(build_model(cfg).param_specs())
    print(f"[100m] {cfg.name}: {n/1e6:.1f}M params")

    # route through the production launcher (checkpoint/resume/monitoring)
    import repro_torch.configs as configs
    configs.ARCHS[cfg.name] = cfg
    os.makedirs(os.path.dirname(METRICS), exist_ok=True)
    return train_launcher.main([
        "--arch", cfg.name, "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq-len", str(args.seq_len),
        "--checkpoint-dir", args.checkpoint_dir,
        "--checkpoint-every", "50", "--lr", "3e-4",
        "--metrics-out", METRICS, "--device", args.device,
    ])


if __name__ == "__main__":
    main()
