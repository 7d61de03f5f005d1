"""The port's optimizers (music_tpu_torch.core.optim) against optax as the
JAX package builds it (music_tpu.core.optim): the same updates and states
on a fixed sequence of gradients, the same state layout in a checkpoint,
and a TrainState checkpoint that either package restores."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_tpu.core import checkpoint as jck
from music_tpu.core import optim as joptim
from music_tpu.train.wavenet_train import TrainState as JTrainState
from music_tpu_torch.core import checkpoint as tck
from music_tpu_torch.core import optim as toptim
from music_tpu_torch.train.wavenet_train import TrainState
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-6  # updates and states are O(1e-2..1); both sides compute in float32

SHAPES = {"fg": (2, 3, 4), "dense": (5,), "post": {"w": (3, 2), "b": (2,)}}

CONFIGS = {
    "sgd": dict(name="sgd", learning_rate=0.05),
    "sgd momentum": dict(name="sgd", learning_rate=0.05, momentum=0.9),
    "rmsprop": dict(name="rmsprop", learning_rate=0.01),
    "rmsprop momentum": dict(name="rmsprop", learning_rate=0.01, momentum=0.9),
    "adam": dict(name="adam", learning_rate=1e-3),
    "adamw": dict(name="adamw", learning_rate=1e-3, weight_decay=0.1),
    "adam clipped": dict(name="adam", learning_rate=1e-3, grad_clip_norm=1.0),
    "sgd clipped, step_lr": dict(name="sgd", momentum=0.5, grad_clip_norm=2.0),
}


def _tree(shapes, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(k, v) for k, v in shapes.items()}


def _random(rng, scale=1.0):
    return _tree(SHAPES, lambda k, s: (scale * rng.standard_normal(s)).astype(np.float32))


def _to_torch(tree):
    return _tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _make(cfg, lib):
    """The optimizer ``cfg`` from ``lib`` (joptim or toptim); the step_lr
    case takes ``lib.step_lr`` as its learning rate."""
    cfg = dict(cfg)
    name = cfg.pop("name")
    lr = cfg.pop("learning_rate", None)
    if lr is None:
        lr = lib.step_lr(0.1, step_size=2, gamma=0.5)
    return lib.make_optimizer(name, lr, **cfg)


def _jax_leaves(state):
    """``{keystr: numpy array}`` of a JAX pytree, as its checkpoint flattens it."""
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(state)[0]}


def _port_leaves(state):
    """The same for a port structure of tensors."""
    return {p: tck._to_numpy(v) for p, v in tck._flatten(state)}


@pytest.mark.parametrize("case", list(CONFIGS))
def test_updates_and_state_match_optax(case):
    """Five steps on the same gradients (large ones, so the clip triggers):
    every update, parameter and state leaf within ATOL of optax's."""
    rng = np.random.default_rng(0)
    params = _random(rng)
    grads = [_random(rng, scale=3.0) for _ in range(5)]
    jtx, ttx = _make(CONFIGS[case], joptim), _make(CONFIGS[case], toptim)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _to_torch(params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for g in grads:
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = ttx.update(_to_torch(g), ts, tp)
        jp, tp = optax.apply_updates(jp, ju), toptim.apply_updates(tp, tu)
        for name, (a, b) in {"updates": (ju, tu), "params": (jp, tp), "state": (js, ts)}.items():
            ja, tb = _jax_leaves(a), _port_leaves(b)
            assert ja.keys() == tb.keys(), name
            for path in ja:
                assert ja[path].dtype == tb[path].dtype, (name, path)
                np.testing.assert_allclose(tb[path], ja[path], rtol=0, atol=ATOL,
                                           err_msg=f"{case} {name} {path}")


@pytest.mark.parametrize("case", list(CONFIGS))
def test_checkpoint_key_paths_equal_a_jax_train_states(case, tmp_path):
    """A port TrainState saves the key paths, dtypes and shapes of a JAX
    TrainState checkpoint, and each package restores the other's."""
    params = _random(np.random.default_rng(1))
    jtx, ttx = _make(CONFIGS[case], joptim), _make(CONFIGS[case], toptim)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = JTrainState(jp, jtx.init(jp), jnp.zeros((), jnp.int32))
    tp = _to_torch(params)
    tstate = TrainState(tp, ttx.init(tp), torch.zeros((), dtype=torch.int32))
    # one update, so the state leaves are not all zero
    g = _random(np.random.default_rng(2))
    ju, jos = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jstate.opt_state, jp)
    jstate = JTrainState(optax.apply_updates(jp, ju), jos, jstate.step + 1)
    tu, tos = ttx.update(_to_torch(g), tstate.opt_state, tp)
    tstate = TrainState(toptim.apply_updates(tp, tu), tos, tstate.step + 1)

    jck.save(tmp_path / "jax", 1, jstate)
    tck.save(tmp_path / "torch", 1, tstate)
    manifests = [tck.json.loads((tmp_path / d / "step_1" / "manifest.json").read_text())
                 for d in ("jax", "torch")]
    assert ([(l["path"], l["dtype"]) for l in manifests[0]["leaves"]]
            == [(l["path"], l["dtype"]) for l in manifests[1]["leaves"]])
    assert any(".opt_state" in l["path"] for l in manifests[0]["leaves"]) == (case != "sgd")
    assert tck.leaf_shapes(tmp_path / "torch") == jck.leaf_shapes(tmp_path / "jax")

    ours = tck.restore(tmp_path / "jax", tstate)  # the port resumes JAX's state
    theirs = jck.restore(tmp_path / "torch", jstate)  # and JAX the port's
    for a, b in ((ours, jstate), (tstate, theirs)):
        la, lb = _port_leaves(a), _jax_leaves(b)
        for path in lb:
            np.testing.assert_allclose(la[path], lb[path], rtol=0, atol=ATOL, err_msg=path)
    assert isinstance(ours.opt_state, tuple) and isinstance(ours.step, torch.Tensor)
    assert ours.step.dtype == torch.int32


def test_step_lr_counts_update_steps():
    schedule = toptim.step_lr(0.1, step_size=3, gamma=0.5)
    jschedule = joptim.step_lr(0.1, step_size=3, gamma=0.5)
    for count in range(8):
        assert schedule(torch.tensor(count)).item() == pytest.approx(float(jschedule(count)))


def test_from_config_and_refusals():
    """``from_config`` reads the train_params keys; lbfgs is not ported
    and names ROADMAP; an unknown name raises."""
    tx = toptim.from_config({"optimizer_type": "rmsprop", "lr": 0.01, "momentum": 0.5})
    state = tx.init({"w": torch.zeros(3)})
    assert [type(s).__name__ for s in state] == ["ScaleByRmsState", "EmptyState", "TraceState"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        toptim.make_optimizer("lbfgs", 1.0)
    with pytest.raises(toptim.OptimizerError):
        toptim.make_optimizer("adagrad", 1.0)


def test_jax_lbfgs_cannot_take_the_trainers_update():
    """Why lbfgs has no port yet: the JAX trainers update by
    ``tx.update(grads, opt_state, params)``, and optax's lbfgs (its zoom
    linesearch) needs the loss too, so ``optimizer: "lbfgs"`` fails at the
    first step of a JAX trainer (ROADMAP.md, section C)."""
    tx = joptim.make_optimizer("lbfgs", 1e-3)
    params = {"w": jnp.ones((4, 3))}
    grads = {"w": jnp.full((4, 3), 0.5)}
    with pytest.raises(TypeError, match="value_fn"):
        tx.update(grads, tx.init(params), params)


def test_restore_refuses_wrong_shapes_kinds_and_missing_leaves(tmp_path):
    state = TrainState({"w": torch.ones(2, 3)}, (toptim.EmptyState(),),
                       torch.zeros((), dtype=torch.int32))
    tck.save(tmp_path, 0, state)
    with pytest.raises(ValueError, match="shape"):
        tck.restore(tmp_path, dataclasses.replace(state, params={"w": torch.ones(3, 2)}))
    with pytest.raises(TypeError, match="dtype"):
        tck.restore(tmp_path, dataclasses.replace(state, step=torch.zeros(())))
    with pytest.raises(KeyError, match="missing leaf"):
        tck.restore(tmp_path, dataclasses.replace(state, params={"v": torch.ones(2, 3)}))
    restored, step = tck.restore_or_init(tmp_path, state)
    assert step == 0 and torch.equal(restored.params["w"], state.params["w"])
    fresh, step = tck.restore_or_init(tmp_path / "none", state)
    assert step == 0 and fresh is state
