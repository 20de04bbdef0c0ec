"""K5, the converter's optimizer step: CUDA kernel launcher and its table.

`conv_adam_step` runs `scene.ConverterOptimizer`'s step on CUDA tensors as
two launches of the hand-written Hopper kernel (`gsavatar_torch/csrc/
conv_adam.cu`) over the leaves where they lie, and counts its launches in
`conv_adam_step.launches`. Launch 1 takes the sums of squares for the
clip's global norm over every gradient (the parameters' and the frozen
subject constants') in chunks of CHUNK elements, one f32 partial a chunk;
launch 2 adds the partials in a fixed order and updates the parameters and
their Adam moments in place. The plain version is
`scene.ConverterOptimizer.step_plain`, which CPU tensors take.

What changes only with the optimizer's state (the sizes, the pointers of
the parameters and moments, the group ids, the block list) is an int64
table in device memory (`table_words`) that a `Plan` builds, copies from
pinned memory and keeps while those pointers and sizes stay; the
gradients' pointers, fresh every step, go by value in the launch's
arguments. Nothing is read back from the device."""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

# elements of one tensor that one block of the kernel takes
CHUNK = 8192
# gradient pointers the kernel's argument struct holds
MAX_TENSORS = 480
# the kernel's rows of step sizes and weight decays, one a group
N_GROUPS = 6
# Adam's scalars: clip, 1 - B1, B1, 1 - B2, B2, bc1, bc2, eps
N_ADAM = 8


def chunk_blocks(numels: Sequence[int]) -> List[int]:
    """One block per CHUNK elements of each tensor, in tensor order, each
    `(tensor index << 32) | chunk index`; a zero-size tensor has none."""
    return [(t << 32) | c for t, n in enumerate(numels)
            for c in range(-(-n // CHUNK))]


def table_words(numels: Sequence[int], n_params: int, p_ptrs, mu_ptrs,
                nu_ptrs, groups) -> tuple:
    """(words, n_norm, n_update): the kernel's table for T = len(numels)
    tensors whose first `n_params` are parameters: the T sizes, the
    parameters', first and second moments' pointers and group ids, then
    the norm's blocks over all T tensors and the update's over the
    parameters."""
    norm = chunk_blocks(numels)
    update = chunk_blocks(numels[:n_params])
    words = [*numels, *p_ptrs, *mu_ptrs, *nu_ptrs, *groups, *norm, *update]
    return words, len(norm), len(update)


def is_dense(t: torch.Tensor) -> bool:
    """Whether t's elements fill numel consecutive floats from its first
    element in some order of its dimensions (contiguous, or a permutation
    of a contiguous layout): the norm's sum of squares can then read it
    as one flat run."""
    expected = 1
    for stride, size in sorted((st, sz) for st, sz in
                               zip(t.stride(), t.shape) if sz != 1):
        if stride != expected:
            return False
        expected *= size
    return True


def _checked(t: torch.Tensor, numel: int, device: int, what: str,
             dense: bool = False) -> int:
    if t.dtype != torch.float32 or t.get_device() != device \
            or t.numel() != numel:
        raise ValueError(f"{what}: K5 takes f32 tensors of {numel} elements "
                         f"on cuda:{device}, got {t.dtype} of {t.numel()} on "
                         f"{t.device}")
    if not (t.is_contiguous() or (dense and is_dense(t))):
        raise ValueError(f"{what}: K5 takes contiguous tensors")
    return t.data_ptr()


class Plan:
    """One optimizer's table on the device, kept while the pointers and
    sizes of its parameters and moments, its group ids and the frozen
    gradients' sizes stay (after `init`, a checkpoint load or a copy of
    the state they change, and the next step builds it anew)."""

    def __init__(self):
        self.key = None

    def update(self, params: list, mu: list, nu: list, frozen_numels: tuple,
               groups: tuple) -> None:
        key = (tuple(map(torch.Tensor.data_ptr, params + mu + nu)),
               tuple(map(torch.Tensor.numel, params + mu + nu)),
               frozen_numels, groups)
        if key == self.key:
            return
        dev = params[0].device
        n = len(params)
        numels = key[1][:n]
        for name, xs in (('parameter', params), ('first moment', mu),
                         ('second moment', nu)):
            for k, x in enumerate(xs):
                _checked(x, numels[k], dev.index, f"{name} {k}")
        words, self.n_norm, self.n_update = table_words(
            numels + frozen_numels, n, key[0][:n], key[0][n:2 * n],
            key[0][2 * n:], groups)
        # the pinned source stays with the plan; the copy does not make the
        # host wait for the stream
        self.staging = torch.tensor(words, dtype=torch.int64).pin_memory()
        self.table = self.staging.to(dev, non_blocking=True)
        self.partials = torch.empty(self.n_norm + 1, dtype=torch.float32,
                                    device=dev)
        self.numels = numels + frozen_numels
        self.key = key

    @property
    def g_norm(self) -> torch.Tensor:
        """The global norm of the last step that clipped (a device
        scalar: launch 2's block 0 stores it after the partials)."""
        return self.partials[self.n_norm]


def _launcher():
    """The kernel's C entry point, its argument types set once."""
    from gsavatar_torch import kernels
    fn = kernels.load('conv_adam').gs_conv_adam
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def conv_adam_step(plan: Plan, params: list, mu: list, nu: list,
                   grads: list, frozen: list, groups: tuple,
                   adam: Sequence[float], steps: Sequence[float],
                   decays: Sequence[float]) -> None:
    """One clipped Adam step on CUDA tensors, in place: `params`, `mu`,
    `nu` and `grads` list the N leaves in one order, `groups` their group
    ids (indices into `steps` and `decays`, N_GROUPS each: the groups' step
    sizes and weight decays), `frozen` the gradients that count in the
    norm only (empty without a clip). `adam`: clip, 1 - B1, B1, 1 - B2, B2,
    bc1, bc2, eps. Raises on what the kernel does not take; no fallback."""
    dev = params[0].device
    if dev.type != 'cuda':
        raise ValueError(f"K5 runs on CUDA tensors, not {dev}")
    n, n_tensors = len(params), len(params) + len(frozen)
    if n_tensors > MAX_TENSORS:
        raise ValueError(f"K5 takes at most {MAX_TENSORS} gradients, got "
                         f"{n_tensors}")
    if not len(mu) == len(nu) == len(grads) == len(groups) == n \
            or len(adam) != N_ADAM \
            or not len(steps) == len(decays) == N_GROUPS:
        raise ValueError(f"K5: one moment pair, gradient and group per "
                         f"parameter, {N_ADAM} Adam scalars and "
                         f"{N_GROUPS} step sizes and decays")
    scalars = [*adam, *steps, *decays]
    plan.update(params, mu, nu, tuple(map(torch.Tensor.numel, frozen)),
                groups)
    ptrs = [_checked(g, k, dev.index, f"gradient {i}")
            for i, (g, k) in enumerate(zip(grads, plan.numels))]
    ptrs += [_checked(g, k, dev.index, f"frozen gradient {i}", dense=True)
             for i, (g, k) in enumerate(zip(frozen, plan.numels[n:]))]
    err = _launcher()(
        (ctypes.c_longlong * n_tensors)(*ptrs), n_tensors, n,
        plan.table.data_ptr(), plan.partials.data_ptr(), plan.n_norm,
        plan.n_update, (ctypes.c_float * len(scalars))(*scalars),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_adam launch failed: CUDA error {err}")
    conv_adam_step.launches += int(adam[0] > 0 and plan.n_norm > 0) \
        + int(plan.n_update > 0)
    # the kernel wrote through raw pointers: tell autograd, and whatever
    # keys a cache on a parameter's version (the distilled skinning voxel)
    torch.autograd.graph.increment_version(params + mu + nu)


conv_adam_step.launches = 0
