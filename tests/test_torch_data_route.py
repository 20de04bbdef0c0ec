"""The `{data: 2}` route of gsavatar_torch against the JAX package's own
two-device route, on the CPU.

Three B = 2 steps of the tiny avatar (tests/test_torch_frames_per_step.py's
shape, iteration 6000 on: every delay gate open) from the same state,
frames, ground truth and draws, four ways:
* JAX, `gsavatar/parallel/shard.py:make_sharded_train_step` on
  `make_mesh(1, data=1, model=1)` and on `make_mesh(2, data=2, model=1)`
  (two of the eight host devices of tests/conftest.py), the pairs route in
  interpret mode;
* the port, `make_batch_train_step` in this process (one device) and
  `make_sharded_train_step` on two gloo ranks (tests/torch_dist_workers.py
  `sharded_steps`).

Each route's state after each step is read per tensor as the mean
absolute difference over the largest |value| of the reference (integer
and boolean tensors exactly). A two-device route leaves its one-device
route by rounding: the data sum adds the frames' gradients in another
order than one device does, and where a gradient is rounding noise (the
isotropic initial Gaussians' rotations) Adam steps by its learning rate in
the direction of that noise's sign. The JAX package's two devices drift
from its one device further than the port's two ranks drift from the
port's one device (measured: the rotation 5.0e-5-5.1e-5 of its largest
value from the first step on, against the port's 0-5.6e-9): the drift is
the reference's (ROADMAP §3). So:
* the port's two ranks hold one state, bit for bit;
* the port's two ranks within 1e-5 of its one device (the gate of
  tests/test_torch_distributed.py), and per tensor no further than 3x the
  JAX package's own two-device drift (or under 1e-7 of the scale);
* the port's two ranks against JAX's two devices at bench.py's gate, a
  mean error under 1e-3 of the largest value: the two packages' one-device
  routes already differ by up to 8.0e-4 there (the second moments of the
  pose encoder's gradients, after tests/test_torch_frames_per_step.py's
  step, whose images agree to the render gates and not bit for bit), so
  the 1e-5 gate cannot hold across the packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from torch_parity import STEP_TINY, jax_draws, jax_named

from gsavatar_torch import convert
from gsavatar_torch import train as ttrain
from gsavatar_torch.config import load_config as t_load_config
from gsavatar_torch.parallel.shard import (make_batch_train_step,
                                           state_tensors)
from gsavatar_torch.scene import Scene as TScene

from gsavatar.config import load_config as j_load_config
from gsavatar.parallel.context import sharding_scope
from gsavatar.parallel.mesh import make_mesh
from gsavatar.parallel.shard import make_sharded_train_step, stack_cameras
from gsavatar.scene import Scene as JScene
from gsavatar.train import loss_weights as j_loss_weights

ITERATION = 6000
STEPS = 3
B = 2
GATE = 1e-5          # tests/test_torch_distributed.py's
PACKAGES = 1e-3      # bench.py's mean-error gate, across the packages
SHARED = 3.0         # "about as much": within this factor
FLOOR = 1e-7         # drifts under this share of the scale count as none


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(scene, before):
    """A port state holding the JAX state `before`."""
    state = scene.init_state()
    scene.converter.load_state_dict(convert.converter_state(
        before.conv_params['params']))
    state.gauss_params, state.gauss_aux = convert.arena(before.gauss_params,
                                                        before.gauss_aux)
    state.gauss_adam = convert.arena_adam(before.gauss_adam)
    return state


def _jax_tensors(j):
    """A JAX state's tensors under the port's `state_tensors` names."""
    params, aux = convert.arena(j.gauss_params, j.gauss_aux)
    adam = convert.arena_adam(j.gauss_adam)
    out = {f'gauss_params.{k}': v for k, v in vars(params).items()}
    out.update({f'gauss_aux.{k}': v for k, v in vars(aux).items()})
    for which in ('m', 'v'):
        out.update({f'adam.{which}.{k}': v
                    for k, v in vars(getattr(adam, which)).items()})
    out.update({f'conv.{k}': torch.from_numpy(v)
                for k, v in jax_named(j.conv_params).items()})
    for which in ('mu', 'nu'):
        for _, st in j.conv_opt[1].inner_states.items():
            moments = [x for x in st.inner_state if hasattr(x, which)]
            if moments:
                out.update({f'{which}.{k}': torch.from_numpy(v) for k, v in
                            jax_named(getattr(moments[0], which)).items()})
    return out


def _drift(got: dict, want: dict) -> dict:
    """Per float tensor, the mean |difference| over the largest |value| of
    `want`; the integer and boolean tensors must be equal."""
    assert set(got) == set(want)
    out = {}
    for k, v in want.items():
        g = got[k]
        if not v.dtype.is_floating_point:
            assert torch.equal(g, v), k
            continue
        scale = float(v.abs().max())
        if scale:
            out[k] = float((g.double() - v.double()).abs().mean()) / scale
    return out


@pytest.fixture(scope='module')
def routes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('data_route')
    jcfg = j_load_config(overrides=["dataset=synthetic"] + STEP_TINY + [
        "rasterizer.backend=pallas_interpret", "rasterizer.chunk=32"])
    js = JScene(jcfg, seed=0)
    before = _np(js.init_state())
    ts = TScene(t_load_config(STEP_TINY), seed=0, device='cpu')
    bucket = js.bucket_for(int(before.gauss_aux.alive.sum()))
    jcams = [js.train_dataset[i] for i in range(B)]
    frames = [(torch.from_numpy(np.array(c.image)),
               torch.from_numpy(np.array(c.mask))) for c in jcams]

    rng, steps = before.rng, []
    for s in range(STEPS):
        it = ITERATION + s
        rng, draws = jax_draws(
            rng, tuple(jcams[0].rots.shape), ts.n_reg_pts,
            int(ts.skinning_pool_pts.shape[0]), ts.converter.pose_noise,
            ts.converter.view_noise, frames=B)
        steps.append((it, dict(j_loss_weights(jcfg, it),
                               _in_densify_window=1.0),
                      dict(ttrain.loss_weights(ts.cfg, it),
                           _in_densify_window=1.0),
                      float(js.xyz_lr_fn(it)), draws))

    def jax_route(n):
        mesh = make_mesh(n, data=n, model=1)
        out = []
        with sharding_scope(mesh):
            step, place = make_sharded_train_step(js, mesh)
            state, batch = place(jax.tree.map(jnp.array, before),
                                 stack_cameras(jcams))
            for it, wj, _, xyz_lr, _ in steps:
                state, _ = step(state, batch, jnp.int32(it), wj, xyz_lr,
                                active_sh_degree=0, bucket=bucket)
                out.append(_jax_tensors(_np(state)))
        return out

    jax1, jax2 = jax_route(1), jax_route(2)

    state = _port_state(ts, before)
    inputs = tmp / 'inputs.pt'
    torch.save({'converter': ts.converter.state_dict(),
                'state': {k: v.clone() for k, v in
                          state_tensors(state).items()},
                'counts': (state.gauss_adam.step, state.conv_opt.count),
                'frames': frames, 'bucket': bucket,
                'steps': [(it, wt, xyz_lr,
                           [dataclasses.asdict(d) for d in draws])
                          for it, _, wt, xyz_lr, draws in steps]}, inputs)
    workers.spawn('sharded_steps', 2, tmp, args=(str(inputs),))
    ranks = [torch.load(tmp / f'rank{r}.pt') for r in range(2)]

    cams = [ts.train_dataset[i].replace(image=img, mask=mask)
            for i, (img, mask) in enumerate(frames)]
    step = make_batch_train_step(ts)
    port1 = []
    for it, _, wt, xyz_lr, draws in steps:
        state, _ = step(state, cams, it, wt, xyz_lr, bucket=bucket,
                        draws=draws)
        port1.append({k: v.detach().clone()
                      for k, v in state_tensors(state).items()})
    strip = lambda d: {k: v for k, v in d.items()
                       if k not in ('generator', 'adam.step',
                                    'conv_opt.count')}
    return {'jax1': jax1, 'jax2': jax2, 'port1': port1,
            'port2': [strip(s) for s in ranks[0]['states']],
            'port2_rank1': [strip(s) for s in ranks[1]['states']]}


def test_two_ranks_hold_one_state(routes):
    for a, b in zip(routes['port2'], routes['port2_rank1']):
        for k, v in a.items():
            assert torch.equal(b[k], v), k


@pytest.mark.parametrize('step', range(STEPS))
def test_port_two_ranks_against_jax_two_devices(routes, step):
    drift = _drift(routes['port2'][step], routes['jax2'][step])
    worst = max(drift, key=drift.get)
    assert drift[worst] <= PACKAGES, (worst, drift[worst])
    one = _drift(routes['port1'][step], routes['jax1'][step])
    print(f"step {step}: the port's two ranks against JAX's two devices "
          f"{drift[worst]:.3e} ({worst}); the one-device routes "
          f"{max(one.values()):.3e} ({max(one, key=one.get)})")


@pytest.mark.parametrize('step', range(STEPS))
def test_two_device_drift_is_the_references(routes, step):
    """The port's two ranks within the gate of its one device, and per
    tensor no further from it than SHARED x the JAX package's two devices
    from its one device (or under FLOOR)."""
    d_jax = _drift(routes['jax2'][step], routes['jax1'][step])
    d_port = _drift(routes['port2'][step], routes['port1'][step])
    assert set(d_jax) == set(d_port)
    for k, p in d_port.items():
        assert p <= GATE, (k, p)
        assert p <= SHARED * max(d_jax[k], FLOOR), (k, p, d_jax[k])
    worst = max(d_jax, key=d_jax.get)
    rot = 'gauss_params.rotation'
    print(f"step {step}: drift from one device, the port's largest "
          f"{max(d_port.values()):.3e} ({max(d_port, key=d_port.get)}), "
          f"JAX's {d_jax[worst]:.3e} ({worst}); the rotation: the port "
          f"{d_port[rot]:.3e}, JAX {d_jax[rot]:.3e}")
