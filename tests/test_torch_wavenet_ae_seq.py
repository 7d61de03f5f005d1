"""The port's WaveNet-autoencoder trainer on meshes of gloo ranks on the
CPU, held against the JAX package's unsharded ``ae.encode``, ``ae.loss_fn``
and ``jax.grad`` on the same weights: the sequence-parallel encoder (a
per-layer halo exchange, its gradient too) at (1, 4, 1) and (2, 2, 1), the
loss and every gradient leaf through the sequence-parallel encoder and
decoder at (1, 2, 2), (1, 4, 1) and (2, 2, 1), and the seq-replicated
branch the trainer takes when the encoder's length does not divide by
``seq``.

One spawned group of 4 ranks runs every case.  Tolerances (float32): the
loss within 1e-5 relative, encodings and each gradient leaf within 1e-5
of their largest magnitude."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from music_tpu.models import wavenet_ae as jae
from music_tpu_torch.core import optim
from music_tpu_torch.models import wavenet_ae as tae
from music_tpu_torch.parallel import launch
from music_tpu_torch.parallel.collectives import sum_grads
from music_tpu_torch.parallel.mesh import MeshSpec, gather, make_mesh, shard_params
from music_tpu_torch.parallel.multihost import host_shard, put_global_batch
from music_tpu_torch.train import wavenet_ae_train as taetrain
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

CFG_JSON = {"filter_width": 2, "dilations": [1, 2, 4, 8, 1, 2, 4, 8],  # M = 30, RF = 32
            "en_residual_channel": 8, "en_dilation_channel": 8, "de_residual_channel": 8,
            "de_dilation_channel": 8, "de_skip_channel": 16, "en_bottleneck_width": 12,
            "en_pool_kernel_size": 4, "quantization_channel": 64}
M = 30
T_SEQ = 32 + M + 2   # encoder length E = 32: seq=4 -> 8 a rank, a multiple of the pool
T_FALLBACK = 33 + M + 2  # E = 33: seq=2 does not divide it
BATCH = 4
ENCODE_MESHES = [(1, 4, 1), (2, 2, 1)]
LOSS_MESHES = [(1, 2, 2), (1, 4, 1), (2, 2, 1)]
FALLBACK_MESHES = [(2, 2, 1), (1, 2, 2)]


def _params():
    params = jae.init_params(jax.random.PRNGKey(0), jae.WaveNetAEConfig.from_json(CFG_JSON))
    return {k: np.asarray(v) for k, v in params.items()}


def _tokens(T, seed=0):
    return np.random.default_rng(seed).integers(0, 64, (BATCH, T)).astype(np.int32)


def _encode_case(mesh, params, inputs, weight):
    """The seq-sharded encoding of this rank's rows and the gradients of
    ``sum(encoding * weight)`` (its rows), summed over ``(data, seq)``."""
    cfg = tae.WaveNetAEConfig.from_json(CFG_JSON)
    p = optim.live(shard_params(mesh, tae.params_from_numpy(params)))
    rows = host_shard(BATCH, mesh)
    enc = taetrain._seq_sharded_encode(p, put_global_batch(mesh, inputs), cfg, mesh)
    # each seq rank holds the whole encoding of its rows: its share is 1/seq
    share = (enc * torch.from_numpy(weight[rows])).sum() / mesh.shape["seq"]
    grads = sum_grads(optim.tree_grads(share, p), mesh)
    return enc.detach().numpy(), {k: v.numpy() for k, v in grads.items()}


def _loss_case(mesh, params, tokens):
    cfg = tae.WaveNetAEConfig.from_json(CFG_JSON)
    loss_fn, specs = taetrain.make_loss_fn(cfg, mesh)
    p = optim.live(shard_params(mesh, tae.params_from_numpy(params), specs))
    loss = loss_fn(p, put_global_batch(mesh, tokens))
    grads = sum_grads(optim.tree_grads(loss, p), mesh)
    return loss.item(), {k: gather(mesh, v, specs[k]).numpy() for k, v in grads.items()}


def _rank_cases(params, tokens_seq, tokens_fallback, weight):
    out = {}

    def on(shape):
        return make_mesh(MeshSpec(*shape), ranks=range(int(np.prod(shape))), device="cpu")

    for shape in ENCODE_MESHES:
        mesh = on(shape)
        out[("encode", shape)] = mesh and _encode_case(mesh, params, tokens_seq[:, :-1], weight)
    for shape in LOSS_MESHES:
        mesh = on(shape)
        out[("loss", shape)] = mesh and _loss_case(mesh, params, tokens_seq)
    for shape in FALLBACK_MESHES:
        mesh = on(shape)
        out[("fallback", shape)] = mesh and _loss_case(mesh, params, tokens_fallback)
    return out


@pytest.fixture(scope="module")
def run():
    params, weight = _params(), np.random.default_rng(3).normal(size=(BATCH, 8, 12))
    tokens_seq, tokens_fallback = _tokens(T_SEQ), _tokens(T_FALLBACK, seed=1)
    ranks = launch.run(_rank_cases, 4, (params, tokens_seq, tokens_fallback,
                                        weight.astype(np.float32)))
    return {"params": params, "weight": weight.astype(np.float32), "tokens_seq": tokens_seq,
            "tokens_fallback": tokens_fallback, "ranks": ranks}


def _jp(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@functools.partial(jax.jit, static_argnums=2)
def _jax_encode(inputs, w, cfg, params):
    """JAX's encoding and the gradients of ``sum(encoding * w)``."""
    enc, vjp = jax.vjp(lambda p: jae.encode(p, inputs, cfg), params)
    return enc, vjp(w)[0]


def _assert_leaves_close(ours, ref, tol=1e-5):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        r = np.asarray(ref[k])
        np.testing.assert_allclose(ours[k], r, rtol=0, atol=tol * np.abs(r).max(), err_msg=k)


@pytest.mark.parametrize("shape", ENCODE_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_seq_sharded_encoder_matches_jax_encode(run, shape):
    """Each rank's encoding (its data rows, gathered over ``seq``) equals
    JAX's unsharded ``ae.encode``; the gradients through the halo
    exchanges and the gather equal ``jax.grad`` of the same sum."""
    cfg = jae.WaveNetAEConfig.from_json(CFG_JSON)
    inputs = jnp.asarray(run["tokens_seq"][:, :-1])
    w = jnp.asarray(run["weight"])
    ref, ref_grads = _jax_encode(inputs, w, cfg, _jp(run["params"]))
    ref = np.asarray(ref)
    assert ref.shape == (BATCH, 8, 12)
    per = BATCH // shape[0]
    for rank, r in enumerate(run["ranks"]):
        enc, grads = r[("encode", shape)]
        d = rank // (shape[1] * shape[2])
        np.testing.assert_allclose(enc, ref[d * per:(d + 1) * per], rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        encoder = {k: v for k, v in ref_grads.items() if k.startswith("en_") or k == "bottleneck"}
        _assert_leaves_close({k: grads[k] for k in encoder}, encoder)
        assert all(not grads[k].any() for k in grads if k not in encoder)


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(which):
    cfg = jae.WaveNetAEConfig.from_json(CFG_JSON)
    tokens = jnp.asarray(_tokens(T_SEQ) if which == "seq" else _tokens(T_FALLBACK, seed=1))
    return jax.jit(jax.value_and_grad(lambda p: jae.loss_fn(p, tokens, cfg)))(_jp(_params()))


def _assert_loss_case(run, key, which):
    loss, grads = _jax_loss_grads(which)
    for r in run["ranks"]:
        ours_loss, ours_grads = r[key]
        assert ours_loss == pytest.approx(float(loss), rel=1e-5)
        _assert_leaves_close(ours_grads, grads)


@pytest.mark.parametrize("shape", LOSS_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_seq_sharded_loss_and_grads_match_jax(run, shape):
    """The sequence-parallel encoder and decoder (the margin, per-layer
    halos, the conditioning indexed by global position) and, at (1, 2, 2),
    the skip path split over ``model``: JAX's ``ae.loss_fn`` and its
    gradients."""
    _assert_loss_case(run, ("loss", shape), "seq")


@pytest.mark.parametrize("shape", FALLBACK_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_fallback_when_the_encoder_length_does_not_divide(run, shape):
    """E = 33 with ``seq=2``: every seq rank computes the whole window and
    the loss is the mean over ``data`` only; the loss and gradients are
    still JAX's."""
    E = T_FALLBACK - 1 - 1 - M
    assert E % shape[1] != 0
    _assert_loss_case(run, ("fallback", shape), "fallback")
