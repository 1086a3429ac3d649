"""Training driver (``repro.launch.train``).

Wires every training layer together: config selection (--arch), the
deterministic data stream with a prefetch thread, the microbatched train
step, checkpointing with restart, failure injection (--fail-at) to drive
the recovery, straggler monitoring and optional int8 gradient
compression.  Runs on ``cuda`` unless ``--device cpu`` is given.

As in the JAX driver, ``--reduced`` is a ``store_true`` flag whose
default is already True, so the CLI always trains the reduced config;
a full-width run goes through the library (``init_train_state``,
``make_train_step``).  The parameters are drawn from a seeded CPU
generator, so a run starts from the same weights on any device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import Prefetcher, synthetic_stream
from repro_torch.train.fault import FailureInjector, StragglerMonitor, run_with_restarts
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a simulated failure at this step (tests recovery)")
    ap.add_argument("--compress", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    opt_cfg = OptConfig(warmup_steps=max(2, args.steps // 10), total_steps=args.steps)
    step_fn = make_train_step(cfg, opt_cfg, n_micro=args.n_micro,
                              use_compression=args.compress, donate=False)
    injector = FailureInjector({args.fail_at} if args.fail_at is not None else set())
    monitor = StragglerMonitor()

    def run(start_step: int) -> int:
        params, opt = init_train_state(cfg, opt_cfg, torch.Generator().manual_seed(args.seed),
                                       use_compression=args.compress, device=dev)
        if args.ckpt_dir:
            state, got = ckpt.restore(args.ckpt_dir, {"params": params, "opt": opt})
            if state is not None:
                params, opt = state["params"], state["opt"]
                start_step = got
                print(f"[train] restored checkpoint @ step {got}")
        stream = Prefetcher(
            synthetic_stream(cfg, args.batch, args.seq, seed=args.seed,
                             start_step=start_step))
        losses = []
        for s, batch in zip(range(start_step, args.steps), stream):
            injector.check(s)
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, batch)
            losses.append(float(metrics["loss"]))  # waits for the step
            dt = time.perf_counter() - t0
            if monitor.record(s, dt):
                print(f"[train] straggler flagged at step {s} ({dt:.3f}s)")
            if s % 5 == 0 or s == args.steps - 1:
                print(f"[train] step {s} loss {losses[-1]:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} ({dt:.3f}s)")
            if args.ckpt_dir and (s + 1) % args.ckpt_every == 0:
                ckpt.save(args.ckpt_dir, s + 1, {"params": params, "opt": opt})
        if len(losses) >= 10:
            a, b = np.mean(losses[:5]), np.mean(losses[-5:])
            print(f"[train] loss {a:.4f} -> {b:.4f} ({'DOWN' if b < a else 'flat'})")
        return args.steps

    final, restarts = run_with_restarts(
        run, (lambda: ckpt.latest_step(args.ckpt_dir)) if args.ckpt_dir else (lambda: 0))
    print(f"[train] finished at step {final} with {restarts} restart(s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
