"""What the drivers ask of the device, so that the CPU tests can drive the
same code at a small size: a sync, the allocator's peak and the profiler's
activities."""
from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity


def is_cuda(device) -> bool:
    return torch.device(device).type == 'cuda'


def sync(device) -> None:
    if is_cuda(device):
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if is_cuda(device) else 0


def activities(device):
    acts = [ProfilerActivity.CPU]
    if is_cuda(device):
        acts.append(ProfilerActivity.CUDA)
    return acts


def f32_matmuls(tf32: bool) -> None:
    """TF32 in cuBLAS's and cuDNN's f32 products on or off: off for the
    reference, on for its control."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
