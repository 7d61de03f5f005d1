"""The port's LeakGAN (music_tpu_torch.models.leakgan, train.leakgan_train,
data.tokens and the ``leakgan train`` command) against music_tpu's on the
same weights at the TINY config of tests/test_leakgan.py, on the CPU.

Every sampler gets JAX's own Gumbel noise for the JAX function's key
splits (``split(key, n_steps)`` in ``_engine_scan``), every dropout JAX's
``bernoulli(k, keep, shape)`` masks, and the tokens must be equal (a
near-tie judged tie-aware at 1e-5)."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_tpu.core import checkpoint as jck
from music_tpu.models import leakgan as jlg
from music_tpu.train import leakgan_train as jtrain
from music_tpu_torch import cli
from music_tpu_torch.core import checkpoint as tck
from music_tpu_torch.models import leakgan as tlg
from music_tpu_torch.train import leakgan_train as ttrain
from test_torch_seqgan import (
    assert_same_tokens, assert_tree_close, gumbel, keep_mask, split_mesh,
)
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

PORT = Path(__file__).resolve().parents[1] / "music_tpu_torch"
ATOL = 1e-5  # forward pieces, engines, losses and rewards, float32 on both sides

KW = dict(vocab_size=40, seq_len=10, step_size=5, goal_size=4, worker_emb_dim=8,
          worker_hidden=8, manager_hidden=8, dis_emb_dim=8, filter_sizes=(1, 2, 3),
          num_filters=(8, 8, 16), dropout=0.2)
JC, TC = jlg.LeakGanConfig(**KW), tlg.LeakGanConfig(**KW)
B, V, G, T = 4, 40, 32, 10
R = 3  # rollouts in the reward tests and the trainer
N = R * JC.n_goals * B  # rollout streams


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(seed=0):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jg, jd = jlg.init_generator(k1, JC, B), jlg.init_discriminator(k2, JC)
    return jg, jd, tlg.params_from_numpy(_np(jg)), tlg.params_from_numpy(_np(jd))


def _tokens(seed=0, hi=V, shape=(B, T)):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(np.int32)


def masks(dkey, n, rows=B):
    return torch.stack([keep_mask(k, JC.dropout, (rows, G)) for k in jax.random.split(dkey, n)])


def _close(ours, theirs, atol=ATOL, msg=""):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(theirs), atol=atol, err_msg=msg)


def test_config_from_json_both_schemas():
    """The shipped flat params and the reference's nested schema give the
    JAX package's config; the derived sizes agree."""
    flat = json.loads((PORT / "params" / "leak_gan" / "leak_gan_params.json").read_text())
    nested = {"discriminator_params": {"vocab_size": 30, "seq_len": 12, "step_size": 4,
                                       "dis_emb_dim": 16, "filter_sizes": [1, 2],
                                       "num_filters": [5, 7], "dropout_keep_prob": 0.75,
                                       "l2_reg_lambda": 0.2, "start_token": 0},
              "generator_params": {"step_size": 4,
                                   "worker_params": {"vocab_size": 30, "goal_size": 8,
                                                     "embed_dim": 6, "hidden_dim": 7},
                                   "manager_params": {"hidden_dim": 7}}}
    for p in (flat, nested, {}):
        ours, theirs = tlg.LeakGanConfig.from_json(p), jlg.LeakGanConfig.from_json(p)
        assert dataclass_dict(ours) == dataclass_dict(theirs)
        assert (ours.goal_out_size, ours.pad_token, ours.n_goals) == (
            theirs.goal_out_size, theirs.pad_token, theirs.n_goals)
    assert tlg.LeakGanConfig.from_json(nested).dropout == pytest.approx(0.25)


def dataclass_dict(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def test_renorm_and_cosine_match_jax():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.standard_normal((5, 6)), 0.01 * rng.standard_normal((3, 6)),
                        np.zeros((1, 6))]).astype(np.float32)
    y = rng.standard_normal((9, 6)).astype(np.float32)
    _close(tlg.renorm_unit_ball(torch.from_numpy(x)), jlg.renorm_unit_ball(jnp.asarray(x)))
    _close(tlg.cosine_similarity(torch.from_numpy(x), torch.from_numpy(y)),
           jlg.cosine_similarity(jnp.asarray(x), jnp.asarray(y)))


def test_inits_have_jax_layout():
    """init_generator / init_discriminator: JAX's trees and shapes
    (goal_init one row per batch row, D's embedding with the pad row),
    std-0.1 normals and truncated normals inside +-0.2, conv biases 0.1."""
    jg, jd, _, _ = _params()
    gen = torch.Generator().manual_seed(0)
    tg, td = tlg.init_generator(gen, TC, B), tlg.init_discriminator(gen, TC)
    for ours, theirs in ((tg, jg), (td, jd)):
        assert jax.tree.structure(tlg.params_to_numpy(ours)) == jax.tree.structure(_np(theirs))
        for a, b in zip(jax.tree.leaves(tlg.params_to_numpy(ours)), jax.tree.leaves(theirs)):
            assert a.shape == b.shape and a.dtype == b.dtype
    assert tg["manager"]["goal_init"].shape == (B, G) and td["embed"].shape == (V + 1, 8)
    big = tlg.init_generator(torch.Generator().manual_seed(1), tlg.LeakGanConfig(), 64)
    assert float(big["worker"]["fc"]["w"].std()) == pytest.approx(0.1, rel=0.05)
    gi = big["manager"]["goal_init"]
    assert float(gi.abs().max()) < 0.2 and float(gi.std()) == pytest.approx(0.088, rel=0.05)
    assert all(float(c["b"].min()) == float(c["b"].max()) == pytest.approx(0.1)
               for c in td["convs"])


@pytest.mark.parametrize("dropout", ["none", "jax mask"])
def test_discriminator_matches_jax(dropout):
    """forward (the feature after highway and dropout), l2 and dis_loss on
    tokens that include the pad id, without dropout and with JAX's mask."""
    _, jd, _, td = _params()
    toks, labels = _tokens(2, hi=V + 1), np.array([1, 0, 0, 1], np.int32)
    dk = jax.random.PRNGKey(3) if dropout == "jax mask" else None
    mask = None if dk is None else keep_mask(dk, JC.dropout, (B, G))
    jout = jlg.discriminator_forward(jd, jnp.asarray(toks), JC, dropout_key=dk)
    tout = tlg.discriminator_forward(td, torch.from_numpy(toks), TC, dropout_mask=mask)
    for k in ("pred", "feature", "score"):
        _close(tout[k], jout[k], msg=k)
    _close(tlg.discriminator_l2(td, TC), jlg.discriminator_l2(jd, JC))
    _close(tlg.dis_loss(td, torch.from_numpy(toks), torch.from_numpy(labels), TC,
                        dropout_mask=mask),
           jlg.dis_loss(jd, jnp.asarray(toks), jnp.asarray(labels), JC, dk))


def test_generator_step_matches_jax():
    jg, _, tg, _ = _params()
    jstate = jlg._init_gen_state(jg, B, JC)
    jstate = dict(jstate, last_goal=jnp.full((B, G), 0.05))
    tstate = {k: torch.from_numpy(np.array(v)) for k, v in jstate.items()}
    f = np.random.default_rng(4).standard_normal((B, G)).astype(np.float32)
    x = _tokens(4)[:, 0]
    key = jax.random.PRNGKey(6)
    jtok, jprobs, jsub, jnew = jlg.generator_step(jg, jnp.asarray(x), jnp.asarray(f), jstate,
                                                  JC, key, 1.0)
    ttok, tprobs, tsub, tnew = tlg.generator_step(
        tg, torch.from_numpy(x), torch.from_numpy(f), tstate, TC, 1.0,
        noise=torch.from_numpy(np.array(jax.random.gumbel(key, (B, V)))))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _close(tprobs, jprobs)
    _close(tsub, jsub)
    for k in jnew:
        _close(tnew[k], jnew[k], msg=k)


def test_engines_match_jax():
    """'pre' (real-data D prefixes, dropout), 'adv' (free-running, dropout)
    and 'gen' under JAX's noise and masks: every output within 1e-5 and the
    same tokens."""
    jg, jd, tg, td = _params()
    data = _tokens(5)
    key, dkey = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
    noise, mask = gumbel(key, T + 1, (B, V)), masks(dkey, T + 1)
    jpre = jlg.pre_engine(jg, jd, jnp.asarray(data), key, cfg=JC, dropout_key=dkey)
    tpre = tlg.pre_engine(tg, td, torch.from_numpy(data), cfg=TC, noise=noise,
                          dropout_mask=mask)
    assert sorted(tpre) == sorted(jpre)
    for k in jpre:
        _close(tpre[k], jpre[k], msg=f"pre {k}")
    jadv = jlg.adv_engine(jg, jd, key, B, cfg=JC, dropout_key=dkey)
    tadv = tlg.adv_engine(tg, td, B, cfg=TC, noise=noise, dropout_mask=mask)
    assert sorted(tadv) == sorted(jadv)
    for k in jadv:
        if k != "gen_token":
            _close(tadv[k], jadv[k], msg=f"adv {k}")
    jgen = jlg.gen_samples(jg, jd, key, B, cfg=JC)
    tgen = tlg.gen_samples(tg, td, B, cfg=TC, noise=noise[:T])
    for ours, theirs in ((tadv["gen_token"], jadv["gen_token"]), (tgen, jgen)):
        assert ours.shape == (B, T)
        assert_same_tokens(ours, theirs, jax_scores(jg, jd, ours, key, noise))


def jax_scores(jg, jd, tokens, key, noise):
    """The JAX engine's noisy log-probabilities [B, T, V], teacher-forced
    on ``tokens``: their argmax is the token JAX draws at each step."""
    _, outs = jlg._engine_scan(jg, jd, JC, key, B, n_steps=T,
                               teacher_tokens=jnp.asarray(tokens.numpy()),
                               teacher_until=jnp.full((B,), T))
    logp = np.log(np.asarray(outs["probs"]).transpose(1, 0, 2))
    return logp + noise[:T].numpy().transpose(1, 0, 2)


def test_get_rewards_match_jax():
    """All R x n_goals x B rollout streams (each from its batch row's
    goal_init) under JAX's noise: rewards within 1e-5."""
    jg, jd, tg, td = _params(1)
    x = np.array(jlg.gen_samples(jg, jd, jax.random.PRNGKey(9), B, cfg=JC))
    key = jax.random.PRNGKey(10)
    theirs = jlg.get_rewards(jg, jd, jnp.asarray(x), key, cfg=JC, rollout_num=R, delta=12.0)
    ours = tlg.get_rewards(tg, td, torch.from_numpy(x), cfg=TC, rollout_num=R, delta=12.0,
                           noise=gumbel(key, T, (N, V)))
    assert ours.shape == (B, JC.n_goals)
    _close(ours, theirs)


def test_rescale_rewards_ties_equal_jax_exactly():
    """Equal sums (identical completions score alike) rank by index, as
    ``jnp.argsort``'s stable sort does: the rescaled rewards are equal to
    JAX's bit for bit, ties and all."""
    sums = np.array([[0.3, 0.1, 0.3, 0.3, 0.2, 0.1, 0.7, 0.3],
                     [1.0] * 8,
                     [0.5, 0.25, 0.5, 0.75, 0.25, 0.5, 0.0, 1.0]], np.float32)
    for delta in (16.0, 3.0):
        ours = tlg.rescale_rewards(torch.from_numpy(sums), delta=delta).numpy()
        theirs = np.asarray(jlg.rescale_rewards(jnp.asarray(sums), delta=delta))
        np.testing.assert_array_equal(ours, theirs)
    assert len(set(ours[1].tolist())) == 8  # a row of ties still ranks 1..8


def test_losses_match_jax():
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    probs = rng.dirichlet(np.ones(V), (B, T)).astype(np.float32)
    probs[0, 0, :] = 0.0  # the clamp at 1e-20
    toks = _tokens(11)
    rewards = rng.uniform(0, 1, (B, JC.n_goals)).astype(np.float32)
    goal, delta = f(B, JC.n_goals, G), f(B, JC.n_goals, G)
    all_goal, dfw = f(B, T, G), f(B, T, G)
    t_, j_ = torch.from_numpy, jnp.asarray
    pairs = [
        (tlg.pre_manager_loss(t_(goal), t_(delta)), jlg.pre_manager_loss(j_(goal), j_(delta))),
        (tlg.pre_worker_loss(t_(toks), t_(probs), V), jlg.pre_worker_loss(j_(toks), j_(probs), V)),
        (tlg.adv_manager_loss(t_(rewards), t_(goal), t_(delta)),
         jlg.adv_manager_loss(j_(rewards), j_(goal), j_(delta))),
        (tlg.adv_worker_loss(t_(all_goal), t_(dfw), t_(toks), t_(probs), V),
         jlg.adv_worker_loss(j_(all_goal), j_(dfw), j_(toks), j_(probs), V)),
    ]
    for i, (ours, theirs) in enumerate(pairs):
        _close(ours, theirs, msg=f"loss {i}")


# ---------------------------------------------------------------------------
# The trainer: one update of each phase from a shared state
# ---------------------------------------------------------------------------

TRAIN = dict(batch_size=B, rollout_num=R, generated_num=8, decay_step_size=2,
             adv_lr_scale=0.5, reward_delta=12.0)


def _jtc():
    return jtrain.LeakGanTrainConfig(cfg=JC, **TRAIN)


def _ttc():
    return ttrain.LeakGanTrainConfig(cfg=TC, **TRAIN)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """A JAX trainer one pretraining step and one D step in (non-zero Adam
    moments and schedule counts), saved by its ``save``."""
    jt = jtrain.LeakGanTrainer(_jtc(), seed=0)
    k = jax.random.split(jax.random.PRNGKey(20), 3)
    jt.g_params, jt.m_opt, jt.w_opt, _, _ = jt._pre_step(
        jt.g_params, jt.d_params, jt.m_opt, jt.w_opt, jnp.asarray(_tokens(21)), k[0], k[1])
    labels = jnp.asarray([1, 0, 1, 0])
    jt.d_params, jt.d_opt, _ = jt._d_step(jt.d_params, jt.d_opt, jnp.asarray(_tokens(22)),
                                          labels, k[2])
    path = tmp_path_factory.mktemp("leakgan_state")
    jt.save(path, 2)
    return jt, path


def _port_trainer(shared):
    """A port trainer restored from the JAX trainer's checkpoint (its
    ``state()``: G, D and the three Adam states, equal leaf for leaf)."""
    jt, path = shared
    tt = ttrain.LeakGanTrainer(_ttc(), seed=0, device="cpu")
    assert tt.restore(path) == 2
    assert_tree_close(tt.state(), jt.state(), rel=0)
    tt.oracle_params = tlg.params_from_numpy(_np(jt.oracle_params))
    return tt


def test_pre_step_matches_jax(shared):
    jt = shared[0]
    tt = _port_trainer(shared)
    data, key, dkey = _tokens(23), jax.random.PRNGKey(24), jax.random.PRNGKey(25)
    g, m_opt, w_opt, ml, wl = jt._pre_step(jt.g_params, jt.d_params, jt.m_opt, jt.w_opt,
                                           jnp.asarray(data), key, dkey)
    tml, twl = tt.pre_step(torch.from_numpy(data), noise=gumbel(key, T + 1, (B, V)),
                           dropout_mask=masks(dkey, T + 1))
    _close(tml, ml)
    _close(twl, wl)
    assert_tree_close({"g": tt.g_params, "m": tt.m_opt, "w": tt.w_opt},
                      {"g": g, "m": m_opt, "w": w_opt})


def test_d_step_matches_jax(shared):
    jt = shared[0]
    tt = _port_trainer(shared)
    toks, labels, dkey = _tokens(26, hi=V + 1), np.array([0, 0, 1, 1], np.int32), \
        jax.random.PRNGKey(27)
    d, d_opt, loss = jt._d_step(jt.d_params, jt.d_opt, jnp.asarray(toks), jnp.asarray(labels),
                                dkey)
    tl = tt.d_step(torch.from_numpy(toks), torch.from_numpy(labels),
                   dropout_mask=keep_mask(dkey, JC.dropout, (B, G)))
    _close(tl, loss)
    assert_tree_close({"d": tt.d_params, "o": tt.d_opt}, {"d": d, "o": d_opt})


def test_adv_step_matches_jax(shared):
    """JAX's ``_adv_step(key, dkey)``; the port's on the noise of
    ``k1, k2 = split(key)`` (the 'adv' engine from ``k1``, the rollouts
    from ``k2``) and the masks of ``dkey``, at ``adv_lr_scale`` 0.5."""
    jt = shared[0]
    tt = _port_trainer(shared)
    key, dkey = jax.random.PRNGKey(28), jax.random.PRNGKey(29)
    g, m_opt, w_opt, ml, wl = jt._adv_step(jt.g_params, jt.d_params, jt.m_opt, jt.w_opt,
                                           key, dkey)
    k1, k2 = jax.random.split(key)
    tml, twl = tt.adv_step(adv_noise=gumbel(k1, T + 1, (B, V)),
                           rollout_noise=gumbel(k2, T, (N, V)), dropout_mask=masks(dkey, T + 1))
    _close(tml, ml)
    _close(twl, wl)
    assert_tree_close({"g": tt.g_params, "m": tt.m_opt, "w": tt.w_opt},
                      {"g": g, "m": m_opt, "w": w_opt})


def test_eval_and_oracle_nll_match_jax(shared):
    """``eval_nll`` over two whole batches (a third, partial one dropped)
    and ``oracle_nll``, under the noise of JAX's keys."""
    jt = shared[0]
    tt = _port_trainer(shared)
    data = _tokens(30, shape=(2 * B + 1, T))
    keys = jax.random.split(jax.random.PRNGKey(31), 2)
    theirs = np.mean([float(jt._eval_nll(jt.g_params, jt.d_params, jnp.asarray(data[i * B:
                                         (i + 1) * B]), k)) for i, k in enumerate(keys)])
    ours = tt.eval_nll(data, noise=[gumbel(k, T + 1, (B, V)) for k in keys])
    assert ours == pytest.approx(float(theirs), abs=ATOL)
    key = jax.random.PRNGKey(32)
    theirs = float(jt._oracle_nll(jt.oracle_params, jt.g_params, jt.d_params, key))
    assert tt.oracle_nll(noise=gumbel(key, T, (B, V))) == pytest.approx(theirs, abs=ATOL)


def test_checkpoints_cross_packages(shared, tmp_path):
    """The port's checkpoint has the JAX ``state()``'s key paths and dtypes,
    and the JAX trainer restores it leaf for leaf (the other direction is
    every test above: the port restores the JAX trainer's save)."""
    jt = shared[0]
    tt = _port_trainer(shared)
    tt.pre_step(torch.from_numpy(_tokens(33)), generator=torch.Generator().manual_seed(0))
    tt.save(tmp_path / "t", 3)
    jt.save(tmp_path / "j", 3)
    manifests = [json.loads((tmp_path / w / "step_3" / "manifest.json").read_text())
                 for w in ("j", "t")]
    assert ([(l["path"], l["dtype"]) for l in manifests[0]["leaves"]]
            == [(l["path"], l["dtype"]) for l in manifests[1]["leaves"]])
    back = jtrain.LeakGanTrainer(_jtc(), seed=5)
    assert back.restore(tmp_path / "t") == 3
    assert_tree_close(tt.state(), back.state(), rel=0)
    assert jck.latest_step(tmp_path / "t") == tck.latest_step(tmp_path / "t") == 3


def test_trainer_phases_run(tmp_path):
    """The phases end to end on the CPU: the oracle corpus, the .npy
    negatives, D and G pretraining, adversarial rounds with interleaved
    supervision and a frozen critic, eval NLL; out-of-range ids refused on
    the host, and the mesh refused."""
    tt = ttrain.LeakGanTrainer(_ttc(), seed=1, device="cpu")
    real = tt.oracle_samples(8)
    assert real.shape == (8, T) and real.dtype == np.int32 and real.max() < V
    neg = tt.generate_samples(6, out_path=tmp_path / "neg.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "neg.npy"), neg)
    assert neg.shape == (6, T)
    assert np.isfinite(tt.pretrain_discriminator(real))
    assert np.isfinite(tt.pretrain_generator(real, epochs=2)).all()
    assert np.isfinite(tt.adversarial_epoch(real, d_steps=1, d_epochs=1,
                                            interleave_supervision=1, d_freeze_refresh=2)).all()
    frozen = tt._frozen_d
    tt.adversarial_epoch(real, d_steps=1, d_epochs=1, d_freeze_refresh=2)
    assert tt._frozen_d is frozen  # refreshed every 2 rounds
    assert np.isfinite([tt.eval_nll(real), tt.oracle_nll()]).all()
    bad = real.copy()
    bad[1, 2] = V
    with pytest.raises(ValueError, match=r"\[0, 40\)"):
        tt.pretrain_discriminator(bad)
    with pytest.raises(ValueError, match="smaller than one batch"):
        tt.eval_nll(real[:3])
    with pytest.raises(ValueError, match="num_filters entry 8 not divisible by model axis 3"):
        ttrain.LeakGanTrainer(_ttc(), mesh=split_mesh(3), device="cpu")


def test_cli_leakgan_train_grows_vocab_and_resumes(tmp_path, capsys):
    """``leakgan train --device cpu`` on a corpus whose ids reach the
    configured vocab_size: the vocabulary grows to cover it (divergence
    #18), a checkpoint is written, and a second run resumes from it."""
    params = tmp_path / "params"
    params.mkdir()
    lg_params = {"seq_len": 10, "vocab_size": 30, "step_size": 5, "goal_size": 4,
                 "hidden_dim": 8, "embed_dim": 8, "start_token": 0, "temperature": 1.0,
                 "dis_emb_dim": 8, "filter_sizes": [1, 2, 3], "num_filters": [8, 8, 16]}
    (params / "leak_gan_params.json").write_text(json.dumps(lg_params))
    (params / "train_params.json").write_text(json.dumps(
        {"batch_size": 4, "m_lr": 0.0015, "w_lr": 0.0015, "d_lr": 5e-5,
         "decay_step_size": 200, "decay_rate": 0.99, "rollout_num": 2,
         "generated_num": 8, "seed": 3}))
    corpus = _tokens(40, hi=31, shape=(8, T))
    corpus[0, 0] = 30
    np.save(tmp_path / "corpus.npy", corpus)
    argv = ["leakgan", "train", "--params-dir", str(params), "--corpus",
            str(tmp_path / "corpus.npy"), "--checkpoint", str(tmp_path / "ck"),
            "--device", "cpu"]
    cli.main(argv)
    out = capsys.readouterr().out
    assert "using vocab_size=31" in out and "resumed from step 0" in out
    assert tck.latest_step(tmp_path / "ck") == 1
    assert tck.leaf_shapes(tmp_path / "ck", "['g_params']")["['worker']['embed']"] == (31, 8)
    cli.main(argv)
    assert "resumed from step 1" in capsys.readouterr().out
