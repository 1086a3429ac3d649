"""End-to-end training on the PyTorch/CUDA port: a reduced gemma2-9b
trained with the whole training substrate (checkpoints, a failure
injected mid-run, the automatic restart from the latest checkpoint, the
straggler monitor), and the loss goes down.

Run:  PYTHONPATH=src python examples/torch_train_lm.py                 # on a GPU
      PYTHONPATH=src python examples/torch_train_lm.py --device cpu

A thin wrapper over ``repro_torch.launch.train``, whose ``--reduced`` is
always on; a full-width run goes through the library.
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def run() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as d:
        return train_main([
            "--arch", "gemma2-9b",
            "--steps", "30",
            "--batch", "8",
            "--seq", "64",
            "--n-micro", "2",
            "--ckpt-dir", d,
            "--ckpt-every", "10",
            "--fail-at", "17",   # drives the crash recovery end to end
            "--device", args.device,
        ])


if __name__ == "__main__":
    run()
