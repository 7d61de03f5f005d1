"""The port's recurrent cells and GAN pytree helpers
(music_tpu_torch.ops.rnn) against music_tpu.ops.rnn on the same weights,
and the optimizer chain the GAN trainers use (clip + adam over trees that
hold lists) against optax."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_tpu.core import checkpoint as jck
from music_tpu.core.optim import step_lr as jstep_lr
from music_tpu.ops import rnn as jrnn
from music_tpu_torch.core import checkpoint as tck
from music_tpu_torch.core import optim as toptim
from music_tpu_torch.core.prng import KeySeq
from music_tpu_torch.ops import rnn as trnn

ATOL = 1e-5  # float32 forward pieces, O(1) values


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("init", ["torch", "normal"])
def test_lstm_cell_and_scan_match_jax(init):
    """One cell step and a 7-step teacher-forced scan (from zeros and from
    a given state), on JAX's weights: within 1e-5; gates in (i, f, g, o)
    order under the same keys."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jp = jrnn.lstm_init(k1, 6, 5, init=init)
    tp = trnn.tree_from_numpy(_np(jp))
    assert sorted(tp) == ["bh", "bi", "wh", "wi"]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 6)).astype(np.float32)
    h0 = rng.standard_normal((3, 5)).astype(np.float32)
    c0 = rng.standard_normal((3, 5)).astype(np.float32)

    jh, jc = jrnn.lstm_cell(jp, jnp.asarray(x[:, 0]), (jnp.asarray(h0), jnp.asarray(c0)))
    th, tc = trnn.lstm_cell(tp, torch.from_numpy(x[:, 0]), (torch.from_numpy(h0),
                                                            torch.from_numpy(c0)))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL)

    for state in (None, (h0, c0)):
        jstate = None if state is None else tuple(map(jnp.asarray, state))
        tstate = None if state is None else tuple(map(torch.from_numpy, state))
        jhs, (jhT, jcT) = jrnn.lstm_scan(jp, jnp.asarray(x), jstate)
        ths, (thT, tcT) = trnn.lstm_scan(tp, torch.from_numpy(x), tstate)
        assert ths.shape == (3, 7, 5)
        for a, b in ((ths, jhs), (thT, jhT), (tcT, jcT)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)


def test_linear_and_zero_state_match_jax():
    jp = jrnn.linear_init(jax.random.PRNGKey(2), 6, 4)
    x = np.random.default_rng(2).standard_normal((5, 6)).astype(np.float32)
    np.testing.assert_allclose(trnn.linear(trnn.tree_from_numpy(_np(jp)), torch.from_numpy(x)),
                               np.asarray(jrnn.linear(jp, jnp.asarray(x))), atol=ATOL)
    h, c = trnn.lstm_zero_state(3, 4)
    assert h.shape == c.shape == (3, 4) and not h.any() and not c.any()
    assert h.data_ptr() != c.data_ptr()


@pytest.mark.parametrize("init", ["torch", "normal"])
def test_inits_have_jax_shapes_and_distributions(init):
    """lstm_init / linear_init / embedding_init: JAX's keys and shapes; U(±1/sqrt(fan))
    for "torch", N(0, 1) for "normal"; an unknown init raises."""
    g = KeySeq(0).next()
    tp = trnn.lstm_init(g, 16, 64, init=init)
    jp = jrnn.lstm_init(jax.random.PRNGKey(0), 16, 64, init=init)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}
    lin = trnn.linear_init(g, 64, 32, init=init)
    assert lin["w"].shape == (64, 32) and lin["b"].shape == (32,)
    w = torch.cat([tp["wi"].flatten(), tp["wh"].flatten()])
    if init == "torch":
        assert w.abs().max() <= 1 / 8 and w.std() == pytest.approx(1 / 8 / 3**0.5, rel=0.1)
        assert lin["w"].abs().max() <= 1 / 8
    else:
        assert float(w.mean()) == pytest.approx(0, abs=0.05)
        assert float(w.std()) == pytest.approx(1, rel=0.05)
    emb = trnn.embedding_init(g, 500, 8, std=0.5)
    assert emb.shape == (500, 8) and float(emb.std()) == pytest.approx(0.5, rel=0.1)
    with pytest.raises(ValueError, match="unknown init"):
        trnn.lstm_init(g, 2, 2, init="xavier")
    with pytest.raises(ValueError, match="unknown init"):
        trnn.linear_init(g, 2, 2, init="xavier")


def test_tree_helpers_keep_jax_structure():
    """A JAX tree with a list of dicts comes across as float32 tensors and
    goes back to the same arrays in the same structure."""
    tree = {"convs": [{"w": np.ones((2, 3), np.float32), "b": np.zeros(3, np.float32)},
                      {"w": np.full((1, 3), 2.0, np.float32), "b": np.ones(3, np.float32)}],
            "out": {"w": np.arange(6, dtype=np.float32).reshape(3, 2)}}
    t = trnn.tree_from_numpy(tree)
    assert isinstance(t["convs"], list) and t["convs"][1]["w"].dtype == torch.float32
    back = trnn.tree_to_numpy(t)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    tree["out"]["w"][0, 0] = 9.0  # the port holds a copy
    assert float(t["out"]["w"][0, 0]) == 0.0


def test_check_token_ids():
    trnn.check_token_ids(np.array([[0, 4], [3, 2]]), 5)
    trnn.check_token_ids(torch.tensor([0, 4]), 5)
    with pytest.raises(ValueError, match=r"\[0, 5\); found ids in \[0, 5\]"):
        trnn.check_token_ids(np.array([0, 5]), 5)
    with pytest.raises(ValueError, match=r"found ids in \[-1, 2\]"):
        trnn.check_token_ids(np.array([-1, 2]), 5)


@pytest.mark.parametrize("schedule", [False, True])
def test_clip_adam_over_a_tree_with_lists_matches_optax(schedule, tmp_path):
    """The GAN trainers' chain, ``clip_by_global_norm(5) + adam(lr)`` (lr a
    step_lr schedule for LeakGAN), on a tree whose ``convs`` is a list:
    params and state within 1e-6 of optax's over four steps, and the state's
    checkpoint leaves under the same key paths."""
    def lr(lib_step_lr):
        return lib_step_lr(0.05, 2, 0.5) if schedule else 0.05

    jtx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(lr(jstep_lr)))
    ttx = toptim.chain(toptim.clip_by_global_norm(5.0), toptim.adam(lr(toptim.step_lr)))
    rng = np.random.default_rng(3)
    shapes = {"convs": [{"w": (2, 3), "b": (3,)}, {"w": (4, 3), "b": (3,)}], "embed": (5, 2)}
    draw = lambda scale: jax.tree.map(
        lambda s: (scale * rng.standard_normal(s)).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    jparams = draw(1.0)
    tparams = trnn.tree_from_numpy(jparams)
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    for step in range(4):
        grads = draw(4.0 if step % 2 else 0.1)  # above and below the clip norm
        jup, jstate = jtx.update(grads, jstate)
        jparams = optax.apply_updates(jparams, jup)
        tup, tstate = ttx.update(trnn.tree_from_numpy(grads), tstate, tparams)
        tparams = toptim.apply_updates(tparams, tup)
    for a, b in zip(jax.tree.leaves(trnn.tree_to_numpy(tparams)), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    jck.save(tmp_path / "j", 4, {"opt": jstate})
    tck.save(tmp_path / "t", 4, {"opt": tstate})
    stored = []
    for which in ("j", "t"):
        manifest = json.loads((tmp_path / which / "step_4" / "manifest.json").read_text())
        with np.load(tmp_path / which / "step_4" / "arrays.npz") as data:
            stored.append({l["path"]: data[l["key"]] for l in manifest["leaves"]})
    assert list(stored[0]) == list(stored[1])
    assert "['opt'][1][0].mu['convs'][1]['w']" in stored[0]
    for path, arr in stored[0].items():
        np.testing.assert_allclose(stored[1][path], arr, atol=1e-6, err_msg=path)


def test_grad_update_is_value_and_grad_then_update():
    """``grad_update`` on a tree with a list: the loss before the update and
    params moved by the optimizer's update of the autograd gradients."""
    params = {"a": [torch.tensor([1.0, -2.0])], "b": torch.tensor(3.0)}
    tx = toptim.make_optimizer("sgd", 0.1)
    new, state, loss = toptim.grad_update(
        tx, params, tx.init(params), lambda p: (p["a"][0] ** 2).sum() + p["b"] * 2)
    assert float(loss) == pytest.approx(11.0)
    np.testing.assert_allclose(new["a"][0].numpy(), [0.8, -1.6], atol=1e-7)
    assert float(new["b"]) == pytest.approx(2.8)
    assert not new["b"].requires_grad and float(params["b"]) == 3.0


def test_keyseq_hands_out_generators_by_device():
    a, b = KeySeq(5), KeySeq(5)
    ga, gb = a.next("cpu"), b.next()
    assert ga.device.type == "cpu"
    assert torch.equal(torch.rand(4, generator=ga), torch.rand(4, generator=gb))
