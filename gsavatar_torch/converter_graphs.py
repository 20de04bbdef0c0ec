"""The converter at playback, replayed from CUDA graphs.

`InferenceScene.render_frame` runs `GaussianConverter.forward` through a
`ConverterGraphs`. On CUDA tensors under inference mode it captures the
whole converter call (pose correction, non-rigid, skinning, texture) as
one `torch.cuda.CUDAGraph` and replays it each frame: one launch on the
host in place of the hundreds of small eager ops the stages launch. The
kernels and their inputs are the same, so a replayed frame equals the
eager one.

A graph bakes in what the host decides at capture. Its key is
`(latent_idx, pose_idx, in_frame_dict, iteration)`; a key captures on the
second consecutive frame that carries it, so that a camera whose key
changes every frame (a training frame of a dataset) stays eager, and a
live camera (one key) captures on its second frame. At most `MAX_GRAPHS`
are held; a new one evicts the graph replayed longest ago. The arena
view's tensors and the non-rigid cache are read in place. Every graph goes
on `reset()` (`InferenceScene._set_arena`: a new arena or converter; also
what a module or parameter replaced in the converter needs) and when one
of the converter's parameters or buffers changes in place (its version, as
`SkinningField._voxel_key` reads it: an optimizer step, a
`load_state_dict`).

Before each replay the camera's tensors (but its ground-truth image and
mask, which no stage reads) are copied into the graph's input buffers.
Every output tensor that the replay writes into the graph's memory pool is
cloned before it is returned, so a package the caller keeps is not
overwritten by later frames; outputs that pass an arena tensor through are
returned as they are. A capture that raises leaves its key eager from then
on. CPU tensors and the training path (`train=True`, or outside inference
mode) always run eagerly.

Counters (`gsavatar_torch.tracing`), one per frame that engages:
`converter/graph_replay`, `converter/graph_capture` (the frame's output is
the new graph's first replay) or `converter/graph_eager`; and
`converter/graph_unsupported` once at a capture that raised. Under replay
the stages' spans (`converter/*`, `non_rigid/*`, `texture/*`) are not
opened; they are on the eager path and during capture."""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Callable, List

import torch

from gsavatar_torch import tracing

MAX_GRAPHS = 4

# the camera's ground truth: no stage of the converter reads it
_GROUND_TRUTH = ('image', 'mask')


def map_tensors(fn: Callable, x):
    """`x` with `fn` applied to every tensor in its dataclasses, dicts,
    tuples and lists."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: map_tensors(fn, getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: map_tensors(fn, v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(map_tensors(fn, v) for v in x)
    return x


def tensors(x) -> List[torch.Tensor]:
    """The tensors in `x`, in the order `map_tensors` visits them."""
    out = []
    map_tensors(out.append, x)
    return out


def _on_cuda_at_inference(gaussians) -> bool:
    return gaussians.get_xyz.is_cuda and torch.is_inference_mode_enabled()


class CudaGraph:
    """One converter call captured on the current CUDA device."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn: Callable):
        """Calls `fn` once on a side stream, so that lazy initialisation
        (cuBLAS handles and workspaces) stays out of the graph, then
        captures a second call; returns that call's outputs, which live in
        the graph's pool."""
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        # thread_local: a reader or writer thread of an app may call CUDA
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode='thread_local'):
            return fn()

    def replay(self):
        self.graph.replay()


class _Entry:
    """A captured graph, its camera input buffers and its outputs."""

    def __init__(self, graph, inputs, out, passed):
        self.graph = graph
        self.inputs = inputs      # {camera field: buffer}
        self.out = out            # (deformed, loss_reg, colors)
        self.owned = {id(t) for t in tensors(out)
                      if t.untyped_storage().data_ptr() not in passed}

    def replay(self, camera):
        for name, buf in self.inputs.items():
            buf.copy_(getattr(camera, name))
        self.graph.replay()
        return map_tensors(
            lambda t: t.clone() if id(t) in self.owned else t, self.out)


class ConverterGraphs:
    """Calls like `converter(gaussians, camera, iteration, nr_cache=...)`;
    see the module's docstring. `graph` makes a graph (`CudaGraph`) and
    `engage(gaussians)` says whether a call may use one."""

    def __init__(self, converter, graph: Callable = CudaGraph,
                 engage: Callable = _on_cuda_at_inference):
        self.graph = graph
        self.engage = engage
        self.reset(converter)

    def reset(self, converter=None):
        """Drops every graph; with `converter`, calls that one from now."""
        if converter is not None:
            self.converter = converter
        # an inference tensor keeps no version counter
        self._leaves = [t for t in (*self.converter.parameters(),
                                    *self.converter.buffers())
                        if not t.is_inference()]
        self._graphs = collections.OrderedDict()
        self._unsupported = set()
        self._last = None
        self._versions = None

    def __call__(self, gaussians, camera, iteration: int, nr_cache=None,
                 train: bool = False, draws=None):
        if train or draws is not None or not self.engage(gaussians):
            return self.converter(gaussians, camera, iteration,
                                  nr_cache=nr_cache, train=train,
                                  draws=draws)
        versions = [t._version for t in self._leaves]
        if versions != self._versions:
            self.reset()
            self._versions = versions
        key = (camera.latent_idx, camera.pose_idx, camera.in_frame_dict,
               iteration)
        last, self._last = self._last, key
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            tracing.count('converter/graph_replay')
            return entry.replay(camera)
        if key == last and key not in self._unsupported:
            entry = self._capture(key, gaussians, camera, iteration, nr_cache)
            if entry is not None:
                tracing.count('converter/graph_capture')
                return entry.replay(camera)
        tracing.count('converter/graph_eager')
        return self.converter(gaussians, camera, iteration,
                              nr_cache=nr_cache)

    def _capture(self, key, gaussians, camera, iteration, nr_cache):
        inputs = {f.name: getattr(camera, f.name).clone()
                  for f in dataclasses.fields(camera)
                  if f.name not in _GROUND_TRUTH
                  and isinstance(getattr(camera, f.name), torch.Tensor)}
        static = camera.replace(image=None, mask=None, **inputs)
        graph = self.graph()
        try:
            out = graph.capture(lambda: self.converter(
                gaussians, static, iteration, nr_cache=nr_cache))
        except Exception as e:        # a stage that reads the device, ...
            self._unsupported.add(key)
            tracing.count('converter/graph_unsupported')
            warnings.warn(f"the converter runs eagerly at key {key}: its "
                          f"capture as a CUDA graph raised {e!r}")
            return None
        passed = {t.untyped_storage().data_ptr()
                  for t in tensors((gaussians, nr_cache))}
        self._graphs[key] = entry = _Entry(graph, inputs, out, passed)
        if len(self._graphs) > MAX_GRAPHS:
            self._graphs.popitem(last=False)
        return entry
