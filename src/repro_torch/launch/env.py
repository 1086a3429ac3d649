"""Runtime environment tuning for serving the port (detect and advise).

The counterpart of the JAX package's ``launch/env.py``, with each JAX or
XLA row replaced by its torch/CUDA analogue:

* ``LD_PRELOAD`` tcmalloc, as in the JAX package: the serving loop stages
  many small host arrays per round (queries, the done/step readback,
  result rows), the churn glibc malloc fragments on;
* ``OMP_NUM_THREADS``: the host threads of torch's CPU ops (the host
  mirror's splices, the ``cpu`` plans), in place of the JAX host-device
  count;
* ``CUDA_MODULE_LOADING=LAZY``: load a CUDA module's kernels at their
  first launch rather than at start-up, in place of skipping the JAX
  plugin probe;
* ``TORCH_CPP_LOG_LEVEL``: quiet torch's C++ logging on the serving path,
  in place of ``TF_CPP_MIN_LOG_LEVEL``.

None of them can be changed from inside a running process that already
uses them: the dynamic linker consumes ``LD_PRELOAD`` at exec, torch reads
``OMP_NUM_THREADS`` and ``TORCH_CPP_LOG_LEVEL`` when it is imported (which
importing this package does), and CUDA reads ``CUDA_MODULE_LOADING`` when
it initialises.  So this module reports and advises; nothing in it calls
into torch's thread or CUDA settings:

* ``detect()``  — what is set right now (and what is available),
* ``advise()``  — the recommended settings with active/inactive flags,
* ``shell_exports()`` — copy-pasteable ``export`` lines for a launcher,
* ``apply()``   — set the advisable variables that are still unset in an
  environment dict (a launcher's, for the process it starts; no-op for
  ``LD_PRELOAD``),
* ``describe()`` — the one-line summary a run prints so that every number
  it reports says which tunings, torch, CUDA and device it ran under.

CLI::

    python -m repro_torch.launch.env            # report + export lines
"""
from __future__ import annotations

import glob
import os
import sys
from typing import Optional

# Where distros put gperftools' tcmalloc (Debian/Ubuntu multiarch, generic
# /usr/lib, and the running environment's prefix, as a conda environment
# has it).  First existing match wins.
TCMALLOC_GLOBS = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc*.so*",
    "/usr/lib/aarch64-linux-gnu/libtcmalloc*.so*",
    "/usr/lib/libtcmalloc*.so*",
    "/usr/local/lib/libtcmalloc*.so*",
    os.path.join(sys.prefix, "lib", "libtcmalloc*.so*"),
)

# torch's C++ log levels are INFO, WARNING, ERROR and FATAL: keep errors.
TORCH_LOG_LEVEL = "ERROR"


def find_tcmalloc() -> Optional[str]:
    for pat in TCMALLOC_GLOBS:
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return None


def detect(env: Optional[dict] = None) -> dict:
    """What the process environment ``env`` (default ``os.environ``) has."""
    env = os.environ if env is None else env
    ld = env.get("LD_PRELOAD", "")
    try:
        threads = int(env.get("OMP_NUM_THREADS", ""))
    except ValueError:
        threads = None
    return {
        "tcmalloc_path": find_tcmalloc(),
        "tcmalloc_active": "tcmalloc" in ld,
        "ld_preload": ld,
        "omp_num_threads": threads,
        "cuda_module_loading": env.get("CUDA_MODULE_LOADING", ""),
        "torch_log_level": env.get("TORCH_CPP_LOG_LEVEL", ""),
        "cpus": os.cpu_count() or 1,
    }


def advise(threads: Optional[int] = None,
           env: Optional[dict] = None) -> list[dict]:
    """Recommended settings as ``{var, value, active, reason}`` rows.
    ``active`` means the environment already satisfies the row.  tcmalloc
    is only advised when the library exists on this host; ``threads``
    defaults to the host's CPUs, at most 8."""
    d = detect(env)
    if threads is None:
        threads = max(1, min(8, d["cpus"]))
    rows = []
    if d["tcmalloc_path"]:
        rows.append({
            "var": "LD_PRELOAD",
            "value": d["tcmalloc_path"],
            "active": d["tcmalloc_active"],
            "reason": "tcmalloc beats glibc malloc under the serving loop's "
                      "small host buffers; must be set before exec",
        })
    rows.append({
        "var": "OMP_NUM_THREADS",
        "value": str(threads),
        "active": d["omp_num_threads"] is not None,
        "reason": "host threads of torch's CPU ops (graph splices, cpu "
                  "plans); read when torch is imported",
    })
    rows.append({
        "var": "CUDA_MODULE_LOADING",
        "value": "LAZY",
        "active": d["cuda_module_loading"] == "LAZY",
        "reason": "load CUDA kernels at first launch, not at start-up; "
                  "read when CUDA initialises",
    })
    rows.append({
        "var": "TORCH_CPP_LOG_LEVEL",
        "value": TORCH_LOG_LEVEL,
        "active": d["torch_log_level"] == TORCH_LOG_LEVEL,
        "reason": "quiet torch's C++ logging on the serving path",
    })
    return rows


def apply(env: Optional[dict] = None, *, threads: Optional[int] = None,
          overwrite: bool = False) -> dict:
    """Write the advisable variables except ``LD_PRELOAD`` into ``env``
    (default ``os.environ``, which processes started afterwards inherit).
    Existing values are kept unless ``overwrite``.  Returns {var: value}
    actually written."""
    env = os.environ if env is None else env
    applied = {}
    for row in advise(threads=threads, env=env):
        var = row["var"]
        if var == "LD_PRELOAD":
            continue  # the dynamic linker already ran; advising only
        if var in env and not overwrite:
            continue
        env[var] = row["value"]
        applied[var] = row["value"]
    return applied


def shell_exports(threads: Optional[int] = None) -> str:
    """Copy-pasteable launcher prelude."""
    return "\n".join(
        f"export {row['var']}={row['value']}"
        for row in advise(threads=threads)
    )


def describe(env: Optional[dict] = None) -> str:
    """One-line summary of the active tunings, torch, CUDA and device."""
    import torch

    d = detect(env)
    device = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
              else "none")
    parts = [
        f"cpus={d['cpus']}",
        "tcmalloc=" + ("on" if d["tcmalloc_active"] else
                       ("avail" if d["tcmalloc_path"] else "absent")),
        "omp_threads=" + (str(d["omp_num_threads"])
                          if d["omp_num_threads"] is not None else "unset"),
        "module_loading=" + (d["cuda_module_loading"] or "default"),
        f"torch={torch.__version__}",
        f"cuda={torch.version.cuda}",
        f"device={device}",
    ]
    return " ".join(parts)


def main() -> int:
    d = detect()
    print("# runtime environment (detected)")
    for k, v in d.items():
        print(f"  {k}: {v!r}")
    print(f"  describe: {describe()}")
    print("# advised (— active, * not yet active)")
    for row in advise():
        mark = "—" if row["active"] else "*"
        print(f"  {mark} {row['var']}={row['value']}  # {row['reason']}")
    print("# launcher prelude")
    print(shell_exports())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
