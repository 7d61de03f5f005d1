"""The trainer's stacked and blocked skip products (``stack_skips``,
``skip_block``) against the JAX trainer's, at the TINY config of
tests/test_wavenet_sharded.py on the same parameters: the loss and every
gradient of ``music_tpu.train.wavenet_train.make_loss_fn`` on a 1x1x1 mesh
against the port's ``models.wavenet.loss_fn`` and ``make_train_step``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_tpu.models import wavenet as jwn
from music_tpu.parallel.mesh import MeshSpec, make_mesh
from music_tpu.train import wavenet_train as jtrain
from music_tpu_torch.core import optim
from music_tpu_torch.models import wavenet as twn
from music_tpu_torch.train import wavenet_train as ttrain
from test_wavenet_sharded import TINY, WL, _data
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

T_TINY = twn.WaveNetConfig(
    filter_width=TINY.filter_width, dilations=TINY.dilations,
    dilation_channels=TINY.dilation_channels, residual_channels=TINY.residual_channels,
    skip_channels=TINY.skip_channels, quantization_channels=TINY.quantization_channels,
    use_bias=TINY.use_bias)
# float32: the tolerances of tests/test_wavenet_sharded.py (measured here: loss
# 6.9e-8 relative, gradients within 7e-10 of JAX's)
F32 = dict(loss_rtol=1e-6, grad_rtol=1e-4, grad_atol=1e-6)
# bf16 compute: XLA and torch round the bf16 products and sums at other
# points.  Measured at TINY, port against JAX: the loss within 5.5e-7
# (stack_skips) and 1.2e-6 (skip_block=3) relative, 4.2e-6 per layer; each
# gradient leaf within 0.162 and 0.152 of its largest magnitude (post1 and
# skip), 0.264 per layer (skip).  The tolerances are 1.7x the per-layer
# loss error and about 2x the blocked gradients' error
BF16 = dict(loss_rtol=7e-6, grad_leaf_frac=0.35)
CASES = {"per layer": ({}, 0), "stack_skips": ({"stack_skips": True}, TINY.n_blocks),
         "skip_block=2": ({"skip_block": 2}, 2),
         "skip_block=3": ({"skip_block": 3}, 3)}  # 3 does not divide 8: a ragged last block


@pytest.fixture(scope="module")
def setup():
    mesh = make_mesh(MeshSpec(data=1, seq=1, model=1), devices=jax.devices()[:1])
    params = jwn.init_params(jax.random.PRNGKey(5), TINY)
    tokens = _data()
    tparams = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    ttokens = torch.from_numpy(np.array(tokens))
    return mesh, params, tokens, tparams, ttokens, {}


def _jax(setup, compute_dtype=None, **kw):
    """JAX's loss and gradients, each program compiled once in the module."""
    mesh, params, tokens, *_, cache = setup
    key = (str(compute_dtype), tuple(sorted(kw.items())))
    if key not in cache:
        fn, _ = jtrain.make_loss_fn(TINY, mesh, WL, compute_dtype=compute_dtype, **kw)
        loss, grads = jax.jit(jax.value_and_grad(fn))(params, tokens)
        cache[key] = float(loss), {k: np.asarray(v) for k, v in grads.items()}
    return cache[key]


def _port(setup, k, compute_dtype=None):
    *_, tparams, ttokens, _ = setup
    live = optim.live(tparams)
    loss = twn.loss_fn(live, ttokens, T_TINY, fuse_taps=True, compute_dtype=compute_dtype,
                       skip_block=k)
    grads = optim.tree_grads(loss, live)
    return float(loss.detach()), {n: g.numpy() for n, g in grads.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_equal_jax_f32(setup, case):
    kw, k = CASES[case]
    jloss, jgrads = _jax(setup, **kw)
    loss, grads = _port(setup, k)
    np.testing.assert_allclose(loss, jloss, rtol=F32["loss_rtol"])
    assert set(grads) == set(jgrads)
    for name in jgrads:
        np.testing.assert_allclose(grads[name], jgrads[name], rtol=F32["grad_rtol"],
                                   atol=F32["grad_atol"], err_msg=f"{case} {name}")


@pytest.mark.parametrize("case", ["stack_skips", "skip_block=3"])
def test_loss_and_grads_equal_jax_bf16(setup, case):
    kw, k = CASES[case]
    jloss, jgrads = _jax(setup, jnp.bfloat16, **kw)
    loss, grads = _port(setup, k, torch.bfloat16)
    np.testing.assert_allclose(loss, jloss, rtol=BF16["loss_rtol"])
    for name, ref in jgrads.items():
        assert grads[name].dtype == np.float32  # the master parameters' dtype
        scale = float(np.abs(ref).max())
        err = float(np.abs(grads[name] - ref).max())
        assert err <= BF16["grad_leaf_frac"] * scale, (case, name, err, scale)


@pytest.mark.parametrize("case", ["stack_skips", "skip_block=3"])
def test_train_step_takes_the_blocked_gradients(setup, case):
    """``make_train_step(..., stack_skips=True)`` / ``skip_block=3``: one
    update by ``params - grads`` moves the parameters by JAX's gradients."""
    kw, _ = CASES[case]
    _, jgrads = _jax(setup, **kw)
    *_, tparams, ttokens, _ = setup
    step = ttrain.make_train_step(T_TINY, optim.scale(-1.0), **kw)
    state = ttrain.TrainState(tparams, optim.scale(-1.0).init(tparams),
                              torch.zeros((), dtype=torch.int32))
    new, _ = step(state, ttokens)
    for name, ref in jgrads.items():
        np.testing.assert_allclose((tparams[name] - new.params[name]).numpy(), ref,
                                   rtol=F32["grad_rtol"], atol=F32["grad_atol"],
                                   err_msg=f"{case} {name}")


def test_defaults_keep_one_skip_product_a_layer(setup):
    """The defaults, and a ``skip_block`` of 1 or below, are the per-layer
    sum, bit for bit."""
    *_, tparams, ttokens, _ = setup
    base = twn.loss_fn(tparams, ttokens, T_TINY, fuse_taps=True)
    assert torch.equal(twn.loss_fn(tparams, ttokens, T_TINY, fuse_taps=True, skip_block=1), base)
    tx = optim.scale(-1.0)
    state = ttrain.TrainState(tparams, tx.init(tparams), torch.zeros((), dtype=torch.int32))
    for kw in ({}, {"skip_block": 1}, {"skip_block": -3}):
        _, loss = ttrain.make_train_step(T_TINY, tx, **kw)(state, ttokens)
        assert torch.equal(loss, base), kw


def test_blocked_skip_biases_equal_jax():
    """With biases, a block adds its layers' skip biases summed: K = 3
    against JAX's ``skip_block=3`` on the same biased parameters."""
    cfg = dataclasses.replace(TINY, use_bias=True)
    tcfg = dataclasses.replace(T_TINY, use_bias=True)
    params = jwn.init_params(jax.random.PRNGKey(9), cfg)
    params = {k: v + 0.05 if k.endswith("_b") else v for k, v in params.items()}
    tokens = _data()
    mesh = make_mesh(MeshSpec(data=1, seq=1, model=1), devices=jax.devices()[:1])
    fn, _ = jtrain.make_loss_fn(cfg, mesh, WL, skip_block=3)
    jloss, jgrads = jax.jit(jax.value_and_grad(fn))(params, tokens)
    live = optim.live({k: torch.tensor(np.asarray(v)) for k, v in params.items()})
    loss = twn.loss_fn(live, torch.from_numpy(np.array(tokens)), tcfg, fuse_taps=True,
                       skip_block=3)
    grads = optim.tree_grads(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=F32["loss_rtol"])
    assert "skip_b" in grads
    for name, ref in jgrads.items():
        np.testing.assert_allclose(grads[name].numpy(), np.asarray(ref), rtol=F32["grad_rtol"],
                                   atol=F32["grad_atol"], err_msg=name)
