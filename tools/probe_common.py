"""What the kernel probes (tools/*_probe.py) share.  A probe puts the tree
it times first on sys.path before it imports this module, so that
``libiop_tpu_torch`` here is that tree's package."""
import os
import subprocess

import torch

from libiop_tpu_torch.kernels import LAUNCHES, build
from tools.device_timing import device_ms, time_ms


def build_sources(stems):
    """Build csrc/<stem>.cu of the tree for each stem, all nvcc processes
    at once, printing each one's register counts (-Xptxas=-v)."""
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    procs = [(stem, subprocess.Popen(
        [build._nvcc(), "-Xptxas=-v", *build.NVCC_FLAGS, "-I",
         build.CSRC_DIR, "-o", os.path.join(build.BUILD_DIR, stem + ".so"),
         os.path.join(build.CSRC_DIR, stem + ".cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)) for stem in stems]
    for stem, proc in procs:
        out = proc.communicate()[0].decode(errors="replace")
        print(stem, "\n".join(line for line in out.splitlines()
                              if "registers" in line or "error" in line))
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {stem}.cu:\n{out}")


def launch_times(fn, key):
    """fn()'s device-only ms (``dev``, how it was taken in ``dev_by``), one
    call between two events (``call``) and the launches one call adds to
    LAUNCHES[key]."""
    before = LAUNCHES[key]
    fn()
    torch.cuda.synchronize()
    launches = LAUNCHES[key] - before
    ms, how = device_ms(fn)
    return {"dev": ms, "dev_by": how, "call": time_ms(fn),
            "launches": launches}
