"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports neither it
nor JAX.  Plain tensor code is PyTorch; every Pallas TPU kernel on a ported
path is a kernel written by hand for Hopper (``repro_torch.kernels``).

Ported so far: the dense-decoder serve path (``models``, ``serve.engine``,
``launch.serve``) and train path (``models.make_train_step``, ``optim``,
``data``, ``runtime``, ``train.loop``, ``launch.train``), with all four
kernels: flash attention (CUDA C++) and RMSNorm (Triton), each with a plain
PyTorch backward, the fused AdamW update (CUDA C++) and the DGC threshold
pass (CUDA C++); and Daydream itself: the simulator core and what-if
registry (``core``, ``obs``, ``parallel.plan``, carried over from ``repro``)
with a trace route of its own (``core.trace_measured``: torch.profiler's
CUDA kernel and runtime records -> dependency graph); checkpoint/restart
(``ckpt``, the reference's on-disk layout; ``runtime.FaultTolerantRunner``)
and goodput under failures (``faults``, ``launch.goodput``).  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; on the CPU each
kernel wrapper runs its plain version.
"""

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    return dev
