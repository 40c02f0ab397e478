"""Training driver: supervised, checkpointed, restartable (the reference's
``launch/train.py``, same flags and output lines).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch smollm-360m --reduced --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch gemma2-2b --batch 2 --seq 4096 --steps 4    # on the card

runs on ``cuda:0`` (raising without CUDA) unless ``--device`` names
another device.  Control flow mirrors a real job: supervisor -> (restore
latest checkpoint) -> step loop with heartbeat, straggler watchdog and
async checkpointing -> on failure (injected by
``--simulate-failure-at``, preemption in production) the supervisor
restarts and the loop resumes from the last committed step.  The
parameters are drawn from ``--seed`` on every (re)start, and the data
stream (``SyntheticTokens``, the same seed) replays by step, so a
restarted run ends on the same state as an uninterrupted one;
``--deterministic`` makes that hold bit for bit on the card
(``torch.use_deterministic_algorithms`` and ``CUBLAS_WORKSPACE_CONFIG``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.data.tokens import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.train.checkpoint import (AsyncCheckpointer, latest_step,
                                          restore_checkpoint)
from repro_torch.train.compression import CompressionConfig
from repro_torch.train.fault_tolerance import (FailureInjector, Heartbeat,
                                               StragglerWatchdog,
                                               run_supervised)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.utils.tree import tree_map


def build(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg, device=resolve_device(args.device))
    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=min(50, args.steps // 5),
                      total_steps=args.steps)
    comp = (CompressionConfig(kind=args.compression)
            if args.compression != "none" else None)
    step_fn = make_train_step(model, opt, microbatches=args.microbatches,
                              compression=comp)
    data = SyntheticTokens(cfg.vocab_size, args.seq, args.batch,
                           seed=args.seed)
    return model, step_fn, data, comp


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--simulate-failure-at", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' for the host")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the parameters and the data stream")
    ap.add_argument("--deterministic", action="store_true",
                    help="deterministic kernels only (bit-exact restarts "
                         "on the card)")
    args = ap.parse_args(argv)
    if args.deterministic:
        # cuBLAS reads this when its first handle is made
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)

    model, step_fn, data, comp = build(args)
    injector = FailureInjector(
        [args.simulate_failure_at] if args.simulate_failure_at >= 0 else [])
    watchdog = StragglerWatchdog()
    heartbeat = Heartbeat(args.ckpt_dir + ".heartbeat", interval_s=5.0)
    ckpt = AsyncCheckpointer(args.ckpt_dir)

    def train_loop(_resume):
        # a write still in flight when the last attempt failed commits
        # first, so the restart point does not depend on thread timing
        ckpt.wait()
        gen = torch.Generator(device=model.device)
        gen.manual_seed(args.seed)
        state = init_train_state(model, generator=gen, compression=comp)
        start = 0
        if latest_step(args.ckpt_dir) is not None:
            template = tree_map(lambda t: t.to("meta"), state)
            del state        # no second copy of the state while restoring
            state, start = restore_checkpoint(args.ckpt_dir, template,
                                              device=model.device)
            print(f"[restore] resumed from step {start}")
        losses = []
        for i in range(start, args.steps):
            injector.check(i)
            t0 = time.time()
            batch = {k: torch.from_numpy(v).to(model.device)
                     for k, v in data.batch_at(i).items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            if watchdog.record(i, dt):
                print(f"[straggler] step {i} took {dt:.2f}s "
                      f"(ewma {watchdog.ewma:.2f}s)")
            heartbeat.beat(i)
            if (i + 1) % args.ckpt_every == 0 or i + 1 == args.steps:
                ckpt.submit(i + 1, state)
            if (i + 1) % args.log_every == 0:
                print(f"step {i+1:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"{dt*1e3:.0f}ms", flush=True)
        ckpt.wait()
        return {"steps": args.steps, "final_loss": losses[-1],
                "straggler_events": len(watchdog.events)}

    report = run_supervised(train_loop, max_restarts=3)
    print(f"[done] steps={report.completed_steps} "
          f"restarts={report.restarts} "
          f"final_loss={report.final_metrics['final_loss']:.4f}")
    return report


if __name__ == "__main__":
    main()
