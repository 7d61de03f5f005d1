"""The port's WaveNet trainer on a (data, seq, model) mesh of gloo ranks on
the CPU, held against the JAX package's unsharded loss and ``jax.grad`` on
the same weights (JAX's own sharded tests hold its sharded loss to the
unsharded one): the loss and every gradient leaf on five meshes, the
stacked and blocked skip products and the biases under ``model=2``, bf16,
one Adam step with a clip norm under ``model=2`` against JAX's
single-device step, and checkpoints crossing between a model-sharded port
run and JAX's single-device trainer in both directions.

One spawned group of 4 ranks runs every case (``_rank_cases``); a mesh of
2 ranks takes ranks 0 and 1.  Tolerances (float32): the loss within 1e-5
relative, each gradient leaf within 1e-5 of its largest magnitude (the
ranks sum their shares in another order than one device's backward);
bf16 as ``tests/test_wavenet_sharded.py::test_bf16_compute_loss_close_to_f32``."""

import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from music_tpu.core import checkpoint as jck
from music_tpu.core.optim import from_config as jfrom_config
from music_tpu.models import wavenet as jwn
from music_tpu.parallel.mesh import MeshSpec as JMeshSpec, make_mesh as jmake_mesh
from music_tpu.train import wavenet_train as jtrain
from music_tpu_torch.core import checkpoint as tck
from music_tpu_torch.core import optim
from music_tpu_torch.models import wavenet as twn
from music_tpu_torch.parallel import launch
from music_tpu_torch.parallel.collectives import sharded_global_norm, sum_grads
from music_tpu_torch.parallel.mesh import MeshSpec, gather, make_mesh, shard_params
from music_tpu_torch.parallel.multihost import put_global_batch
from music_tpu_torch.train import wavenet_train as ttrain
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

CFG_JSON = {"filter_width": 2, "dilations": [1, 2, 4, 8, 1, 2, 4, 8], "dilation_channels": 4,
            "residual_channels": 4, "skip_channels": 8, "quantization_channels": 32,
            "use_bias": False}
WL = 16  # window: seq=2 -> 8 a rank
BATCH = 4
MESHES = [(2, 1, 1), (1, 2, 1), (1, 1, 2), (1, 2, 2), (2, 1, 2)]
TRAIN = {"optimizer": "adam", "learning_rate": 1e-2, "grad_clip_norm": 0.005}
"""Adam steps whose clip engages (the first gradients' norm is 0.0144)."""


def _cfg(use_bias=False):
    return dict(CFG_JSON, use_bias=use_bias)


def _params(use_bias=False):
    params = jwn.init_params(jax.random.PRNGKey(0), jwn.WaveNetConfig.from_json(_cfg(use_bias)))
    rng = np.random.default_rng(1)  # biases nonzero, so their gradients are checked
    return {k: np.asarray(v) + (rng.normal(0, 0.1, v.shape).astype(np.float32)
                                if k.endswith("_b") else 0) for k, v in params.items()}


def _tokens():
    rf = jwn.WaveNetConfig.from_json(CFG_JSON).receptive_field
    return np.random.default_rng(0).integers(0, 32, (BATCH, rf + WL)).astype(np.int32)


def _gathered(mesh, tree, specs):
    return {k: gather(mesh, v, specs[k]).numpy() for k, v in tree.items()}


def _loss_grads(mesh, params, tokens, use_bias=False, **kw):
    """The mesh's loss and its gradients summed and gathered."""
    cfg = twn.WaveNetConfig.from_json(_cfg(use_bias))
    loss_fn, specs = ttrain.make_loss_fn(cfg, mesh, WL, **kw)
    p = optim.live(shard_params(mesh, twn.params_from_numpy(params), specs))
    loss = loss_fn(p, put_global_batch(mesh, tokens))
    grads = sum_grads(optim.tree_grads(loss, p), mesh)
    assert all(g.dtype == torch.float32 for g in grads.values())
    return loss.item(), _gathered(mesh, grads, specs)


def _state_arrays(mesh, state, specs):
    adam = state.opt_state[1][0]
    return {"params": _gathered(mesh, state.params, specs), "mu": _gathered(mesh, adam.mu, specs),
            "nu": _gathered(mesh, adam.nu, specs)}


def _adam_steps(mesh, params, tokens, n_steps, ckpt_save=None, ckpt_restore=None):
    """``n_steps`` clipped Adam steps on the mesh from ``params`` (or from
    the checkpoint ``ckpt_restore``), saving after the first to ``ckpt_save``."""
    cfg = twn.WaveNetConfig.from_json(CFG_JSON)
    specs = ttrain.param_specs(cfg, mesh.shape["model"] > 1)
    tx = optim.from_config(TRAIN, global_norm=sharded_global_norm(mesh, specs))
    local = shard_params(mesh, twn.params_from_numpy(params), specs)
    state = ttrain.TrainState(local, tx.init(local), torch.zeros((), dtype=torch.int32))
    if ckpt_restore is not None:
        state, step = tck.restore_or_init(ckpt_restore, state, mesh=mesh, specs=specs)
        assert step == 1 and int(state.step) == 1
    step_fn = ttrain.make_train_step(cfg, tx, mesh=mesh, window_length=WL)
    batch = put_global_batch(mesh, tokens)
    losses = []
    for i in range(n_steps):
        state, loss = step_fn(state, batch)
        losses.append(loss.item())
        if i == 0 and ckpt_save is not None:
            tck.save(ckpt_save, int(state.step), state, mesh=mesh, specs=specs)
    return {"losses": losses, **_state_arrays(mesh, state, specs)}


def _rank_cases(params, bias_params, tokens, ckpt_fwd, ckpt_rev):
    """Every case on this rank; a rank outside a case's mesh gets None."""
    out = {}

    def on(shape):
        return make_mesh(MeshSpec(*shape), ranks=range(int(np.prod(shape))), device="cpu")

    for shape in MESHES:
        mesh = on(shape)
        out[("f32", shape)] = mesh and _loss_grads(mesh, params, tokens)
    mesh = on((1, 1, 2))
    out["stack_skips"] = mesh and _loss_grads(mesh, params, tokens, stack_skips=True)
    out["skip_block"] = mesh and _loss_grads(mesh, params, tokens, skip_block=2)
    mesh = on((2, 1, 2))
    out["bias"] = mesh and _loss_grads(mesh, bias_params, tokens, use_bias=True)
    out["bf16"] = mesh and _loss_grads(mesh, params, tokens, compute_dtype=torch.bfloat16)
    mesh = on((1, 1, 2))
    out["adam"] = mesh and _adam_steps(mesh, params, tokens, 1)
    out["ckpt_fwd"] = mesh and _adam_steps(mesh, params, tokens, 2, ckpt_save=ckpt_fwd)
    out["ckpt_rev"] = mesh and _adam_steps(mesh, params, tokens, 1, ckpt_restore=ckpt_rev)
    out["world"] = dist.get_world_size()
    return out


@functools.lru_cache(maxsize=1)
def _jax_step_fn():
    """JAX's single-device trainer step (one compile for the module)."""
    cfg = jwn.WaveNetConfig.from_json(CFG_JSON)
    mesh = jmake_mesh(JMeshSpec(data=1), devices=jax.devices()[:1])
    return jtrain.make_train_step(cfg, jfrom_config(TRAIN), mesh, WL)[0]


def _jax_steps(params, tokens, n_steps, state=None):
    """JAX's single-device trainer step ``n_steps`` times."""
    tx = jfrom_config(TRAIN)
    step_fn = _jax_step_fn()
    if state is None:
        p = {k: jnp.asarray(v) for k, v in params.items()}
        state = jtrain.TrainState(p, tx.init(p), jnp.zeros((), jnp.int32))
    losses = []
    for _ in range(n_steps):
        state, loss = step_fn(state, jnp.asarray(tokens))
        losses.append(float(loss))
    return state, losses


def _jax_arrays(state):
    adam = state.opt_state[1][0]
    return {"params": state.params, "mu": adam.mu, "nu": adam.nu}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    params, bias_params, tokens = _params(), _params(use_bias=True), _tokens()
    state1, _ = _jax_steps(params, tokens, 1)
    jck.save(tmp / "rev", 1, state1)
    ranks = launch.run(_rank_cases, 4, (params, bias_params, tokens, tmp / "fwd", tmp / "rev"))
    return {"params": params, "bias_params": bias_params, "tokens": tokens, "tmp": tmp,
            "ranks": ranks}


def _jax_loss_grads(params, tokens, use_bias=False):
    cfg = jwn.WaveNetConfig.from_json(_cfg(use_bias))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda q: jwn.loss_fn(q, jnp.asarray(tokens), cfg)))(p)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _assert_leaves_close(ours, ref, tol=1e-5):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        r = np.asarray(ref[k])
        np.testing.assert_allclose(ours[k], r, rtol=0, atol=tol * max(np.abs(r).max(), 1e-30),
                                   err_msg=k)


def _assert_case(run, key, use_bias=False, n_ranks=None):
    ref_loss, ref_grads = _jax_loss_grads(run["bias_params" if use_bias else "params"],
                                          run["tokens"], use_bias)
    results = [r[key] for r in run["ranks"] if r[key] is not None]
    assert len(results) == (n_ranks or len(results))
    for loss, grads in results:  # every rank: the same global loss, whole gradients
        assert loss == pytest.approx(ref_loss, rel=1e-5)
        _assert_leaves_close(grads, ref_grads)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_loss_and_grads_match_jax_unsharded(run, shape):
    _assert_case(run, ("f32", shape), n_ranks=int(np.prod(shape)))


@pytest.mark.parametrize("key", ["stack_skips", "skip_block"])
def test_stacked_and_blocked_skips_under_model_split(run, key):
    """``stack_skips`` and ``skip_block=2`` with the skip path split over
    ``model=2``: the same loss and gradients."""
    _assert_case(run, key, n_ranks=2)


def test_biases_split_with_the_skip_path(run):
    """``use_bias``: ``skip_b`` split over ``model``, ``post1_b`` added after
    the row-parallel sum, on a (2, 1, 2) mesh."""
    _assert_case(run, "bias", use_bias=True, n_ranks=4)


def test_bf16_compute_loss_close_to_f32(run):
    """bf16 ``compute_dtype`` on a (2, 1, 2) mesh: the loss within 2% of
    JAX's float32 loss (the JAX test's bound), master gradients float32."""
    ref_loss, _ = _jax_loss_grads(run["params"], run["tokens"])
    for r in run["ranks"]:
        loss, grads = r["bf16"]
        assert abs(loss - ref_loss) / abs(ref_loss) < 0.02, (loss, ref_loss)
        assert all(np.isfinite(g).all() for g in grads.values())


def test_clipped_adam_step_under_model_split_equals_jax_single_device(run):
    """One Adam step with ``grad_clip_norm`` under ``model=2``: the norm is
    the whole arrays' (split leaves' squares summed over ``model``), so the
    moments, which hold the clipped gradient, and the parameters equal JAX's
    single-device ``make_train_step`` step."""
    state, losses = _jax_steps(run["params"], run["tokens"], 1)
    ref = _jax_arrays(state)
    ours = run["ranks"][0]["adam"]
    assert ours["losses"][0] == pytest.approx(losses[0], rel=1e-5)
    for part in ("params", "mu", "nu"):
        _assert_leaves_close(ours[part], ref[part])
    # the clip engaged: the moments hold the gradients scaled by clip / norm
    _, grads = _jax_loss_grads(run["params"], run["tokens"])
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    assert norm > 2 * TRAIN["grad_clip_norm"]
    np.testing.assert_allclose(ours["mu"]["skip"],
                               0.1 * grads["skip"] * TRAIN["grad_clip_norm"] / norm,
                               rtol=1e-4, atol=1e-5 * np.abs(0.1 * grads["skip"]).max())


def test_checkpoint_from_model_split_run_resumes_in_jax(run):
    """A (1, 1, 2) run saves after its first step (rank 0 writes whole
    arrays); JAX's single-device ``restore_or_init`` resumes it, and its
    second step equals the port's."""
    assert sorted(p.name for p in (run["tmp"] / "fwd").iterdir()) == ["step_1"]
    cfg = jwn.WaveNetConfig.from_json(CFG_JSON)
    example = jtrain.init_state(jax.random.PRNGKey(5), cfg, jfrom_config(TRAIN))
    state, step = jck.restore_or_init(run["tmp"] / "fwd", example)
    assert step == 1 and int(state.step) == 1
    state, losses = _jax_steps(None, run["tokens"], 1, state)
    ours = run["ranks"][0]["ckpt_fwd"]
    assert ours["losses"][1] == pytest.approx(losses[0], rel=1e-5)
    ref = _jax_arrays(state)
    for part in ("params", "mu", "nu"):
        _assert_leaves_close(ours[part], ref[part])


def test_jax_checkpoint_resumes_on_model_split_mesh(run):
    """JAX's single-device checkpoint after one step, restored on a (1, 1,
    2) mesh (each rank keeping its block): the port's next step equals
    JAX's second."""
    state, losses = _jax_steps(run["params"], run["tokens"], 2)
    ours = run["ranks"][0]["ckpt_rev"]
    assert ours["losses"][0] == pytest.approx(losses[1], rel=1e-5)
    ref = _jax_arrays(state)
    for part in ("params", "mu", "nu"):
        _assert_leaves_close(ours[part], ref[part])


def test_one_group_of_four_ranks(run):
    assert [r["world"] for r in run["ranks"]] == [4, 4, 4, 4]
    assert [r[("f32", (2, 1, 1))] is None for r in run["ranks"]] == [False, False, True, True]
