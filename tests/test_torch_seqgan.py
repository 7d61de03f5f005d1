"""The port's SeqGAN (music_tpu_torch.models.seqgan, train.seqgan_train and
the ``seqgan train`` command) against music_tpu's on the same weights at
the TINY config of tests/test_seqgan.py, on the CPU.

Sampling parity: ``jax.random.categorical(key, logits)`` is
``argmax(logits + jax.random.gumbel(key, logits.shape))``, so the tests
draw JAX's own Gumbel noise with the JAX function's key splits, feed it to
the port, and demand the same tokens (a near-tie judged tie-aware at
1e-5).  Dropout masks are JAX's ``bernoulli(key, keep, shape)``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_tpu.core import checkpoint as jck
from music_tpu.models import seqgan as jsg
from music_tpu.train import seqgan_train as jtrain
from music_tpu_torch import cli
from music_tpu_torch.core import checkpoint as tck
from music_tpu_torch.models import seqgan as tsg
from music_tpu_torch.parallel.mesh import GROUPS, Mesh, MeshSpec, make_mesh
from music_tpu_torch.train import seqgan_train as ttrain
from music_tpu_torch.utils.parity import tie_aware_check
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5  # forward pieces and rewards, float32 on both sides
REL = 1e-5  # params and optimizer state after one update, per leaf

G = dict(vocab_size=50, emb_dim=8, hidden_dim=8, seq_len=10)
D = dict(vocab_size=50, emb_dim=8, filter_sizes=(1, 2, 3), num_filters=(8, 8, 8), seq_len=10)
JG, TG = jsg.GeneratorConfig(**G), tsg.GeneratorConfig(**G)
JD, TD = jsg.DiscriminatorConfig(**D), tsg.DiscriminatorConfig(**D)
B = 4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(init="torch"):
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jg, jd = jsg.init_generator(k1, JG, init=init), jsg.init_discriminator(k2, JD)
    return jg, jd, tsg.params_from_numpy(_np(jg)), tsg.params_from_numpy(_np(jd))


def _tokens(seed=0, shape=(B, 10)):
    return np.random.default_rng(seed).integers(0, 50, shape).astype(np.int32)


def gumbel(key, n, shape):
    """JAX's Gumbel draws of ``n`` scan steps: ``gumbel(k, shape)`` for
    ``k`` in ``split(key, n)``."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.gumbel(k, shape))
                                      for k in jax.random.split(key, n)]))


def keep_mask(key, rate, shape):
    return torch.from_numpy(np.array(jax.random.bernoulli(key, 1.0 - rate, shape)))


def assert_same_tokens(ours, theirs, scores):
    """Every port token within 1e-5 of the best score at its step,
    ``scores [B, T, V]`` the JAX model's noisy logits teacher-forced on the
    port's tokens (so equal tokens pass, and a near-tie may flip one); with
    no near-tie in the scores, the tokens equal JAX's."""
    ours = np.asarray(ours)
    info = tie_aware_check(ours, lambda t: scores, 1e-5)
    assert info["ok"], info
    top2 = np.sort(scores, axis=-1)[..., -2:]
    if (top2[..., 1] - top2[..., 0]).min() > 1e-5:
        np.testing.assert_array_equal(ours, np.asarray(theirs))


def leaves_by_path(tree, jax_tree: bool):
    if jax_tree:
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}
    return {p: (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in tck._flatten(tree)}


def assert_tree_close(ours, theirs, rel=REL):
    """The same key paths; each leaf within ``rel`` of its largest
    magnitude (integers, such as Adam's count, equal)."""
    a, b = leaves_by_path(ours, False), leaves_by_path(theirs, True)
    assert list(a) == list(b)
    for path, want in b.items():
        got = a[path]
        assert got.shape == want.shape, path
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, rtol=0, err_msg=path,
                                       atol=rel * max(float(np.abs(want).max()), 1e-30))


def split_mesh(m: int) -> Mesh:
    """Rank 0's view of a ``model=m`` mesh with no process group: enough for
    a trainer's refusal, which comes before any collective."""
    return Mesh(np.arange(m).reshape(1, 1, m), 0, torch.device("cpu"), dict.fromkeys(GROUPS))


def test_configs_mirror_jax():
    assert TG == tsg.GeneratorConfig(**vars(JG))
    assert TD.feature_dim == JD.feature_dim == 24
    assert tsg.DiscriminatorConfig() == tsg.DiscriminatorConfig(**vars(jsg.DiscriminatorConfig()))
    assert ttrain.SeqGanConfig().__dict__.keys() == jtrain.SeqGanConfig().__dict__.keys()


@pytest.mark.parametrize("init", ["torch", "normal"])
def test_generator_logits_and_nll_match_jax(init):
    jg, _, tg, _ = _params(init)
    toks = _tokens()
    np.testing.assert_allclose(
        tsg.generator_logits(tg, torch.from_numpy(toks), TG).numpy(),
        np.asarray(jsg.generator_logits(jg, jnp.asarray(toks), JG)), atol=ATOL)
    assert float(tsg.generator_nll(tg, torch.from_numpy(toks), TG)) == pytest.approx(
        float(jsg.generator_nll(jg, jnp.asarray(toks), JG)), abs=ATOL)


@pytest.mark.parametrize("init", ["torch", "normal"])
def test_generate_equals_jax_under_its_gumbel_noise(init):
    jg, _, tg, _ = _params(init)
    key = jax.random.PRNGKey(11)
    theirs = np.asarray(jsg.generate(jg, key, JG, 6))
    noise = gumbel(key, 10, (6, 50))
    ours = tsg.generate(tg, TG, 6, noise=noise)
    assert ours.shape == (6, 10) and ours.dtype == torch.int64
    scores = np.asarray(jsg.generator_logits(jg, jnp.asarray(ours.numpy()), JG))
    assert_same_tokens(ours, theirs, scores + noise.numpy().transpose(1, 0, 2))


def test_generate_draws_from_its_generator():
    """Without noise: the generator's draws, reproducible from its seed,
    and distributed as the model's softmax (first token, 4000 rows)."""
    _, _, tg, _ = _params("normal")
    a = tsg.generate(tg, TG, 4000, generator=torch.Generator().manual_seed(1))
    b = tsg.generate(tg, TG, 4000, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    h, c = tsg.lstm_cell(tg["lstm"], tg["embed"][torch.zeros(1, dtype=torch.long)],
                         tsg.lstm_zero_state(1, 8))
    probs = torch.softmax(tsg.linear(tg["out"], h), -1)[0]
    freq = torch.bincount(a[:, 0], minlength=50).float() / 4000
    assert float((freq - probs).abs().max()) < 0.03


@pytest.mark.parametrize("dropout", ["none", "jax mask"])
def test_discriminator_matches_jax(dropout):
    """features, forward (pred, feature, score), pos_prob and loss within
    1e-5, without dropout and with the mask JAX draws from its key."""
    _, jd, _, td = _params()
    toks, labels = _tokens(1), np.array([1, 0, 1, 0], np.int32)
    dk = jax.random.PRNGKey(5) if dropout == "jax mask" else None
    mask = None if dk is None else keep_mask(dk, JD.dropout, (B, JD.feature_dim))
    jout = jsg.discriminator_forward(jd, jnp.asarray(toks), JD, dropout_key=dk)
    tout = tsg.discriminator_forward(td, torch.from_numpy(toks), TD, dropout_mask=mask)
    for k in ("pred", "feature", "score"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=ATOL, err_msg=k)
    np.testing.assert_allclose(tsg.discriminator_features(td, torch.from_numpy(toks), TD),
                               np.asarray(jsg.discriminator_features(jd, jnp.asarray(toks), JD)),
                               atol=ATOL)
    np.testing.assert_allclose(tsg.discriminator_pos_prob(td, torch.from_numpy(toks), TD),
                               np.asarray(jsg.discriminator_pos_prob(jd, jnp.asarray(toks), JD)),
                               atol=ATOL)
    jl = jsg.discriminator_loss(jd, jnp.asarray(toks), jnp.asarray(labels), JD, dk)
    tl = tsg.discriminator_loss(td, torch.from_numpy(toks), torch.from_numpy(labels), TD,
                                dropout_mask=mask)
    assert float(tl) == pytest.approx(float(jl), abs=ATOL)


@pytest.mark.parametrize("sizes", [(1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 15, 20), (3, 1, 2, 9)])
def test_discriminator_filter_sizes_match_jax(sizes):
    """The shipped 12 filter sizes (up to the whole sequence) and an
    unsorted set, at seq_len 20: features and the gradient of the loss
    within 1e-5 of JAX's."""
    cfg = dict(vocab_size=50, emb_dim=8, filter_sizes=sizes, num_filters=(3,) * len(sizes),
               seq_len=20)
    jcfg, tcfg = jsg.DiscriminatorConfig(**cfg), tsg.DiscriminatorConfig(**cfg)
    jd = jsg.init_discriminator(jax.random.PRNGKey(7), jcfg)
    td = tsg.params_from_numpy(_np(jd))
    toks, labels = _tokens(9, (B, 20)), np.array([1, 0, 1, 1], np.int32)
    jfeat = jax.jit(jsg.discriminator_features, static_argnums=2)
    np.testing.assert_allclose(tsg.discriminator_features(td, torch.from_numpy(toks), tcfg),
                               np.asarray(jfeat(jd, jnp.asarray(toks), jcfg)), atol=ATOL)
    jgrad = jax.jit(jax.grad(jsg.discriminator_loss), static_argnums=3)(
        jd, jnp.asarray(toks), jnp.asarray(labels), jcfg)
    live = jax.tree.map(lambda t: t.requires_grad_(True), td)
    tsg.discriminator_loss(live, torch.from_numpy(toks), torch.from_numpy(labels), tcfg).backward()
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.grad.numpy(), live)),
                    jax.tree.leaves(_np(jgrad))):
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_discriminator_init_has_jax_layout():
    td = tsg.init_discriminator(torch.Generator().manual_seed(0), TD)
    _, jd, _, _ = _params()
    assert jax.tree.structure(tsg.params_to_numpy(td)) == jax.tree.structure(_np(jd))
    for a, b in zip(jax.tree.leaves(tsg.params_to_numpy(td)), jax.tree.leaves(_np(jd))):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert all(float(c["b"].abs().max()) == 0 for c in td["convs"])
    assert float(td["convs"][2]["w"].abs().max()) <= 1 / (3 * 8) ** 0.5


def test_rollout_rewards_match_jax():
    """R x (T-1) x B streams under JAX's noise (``split(key, T-1)``):
    rewards within 1e-5; the last column is D on the sample."""
    jg, jd, tg, td = _params("normal")
    samples = _tokens(2)
    key = jax.random.PRNGKey(3)
    theirs = np.asarray(jsg.rollout_rewards(jg, jd, jnp.asarray(samples), key, g_cfg=JG,
                                            d_cfg=JD, rollout_num=3))
    ours = tsg.rollout_rewards(tg, td, torch.from_numpy(samples), g_cfg=TG, d_cfg=TD,
                               rollout_num=3, noise=gumbel(key, 9, (3 * 9 * B, 50)))
    assert ours.shape == (B, 10)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=ATOL)
    np.testing.assert_allclose(ours[:, -1], tsg.discriminator_pos_prob(
        td, torch.from_numpy(samples), TD), atol=0)


def test_pg_loss_and_its_gradient_match_jax():
    jg, _, tg, _ = _params()
    samples, rewards = _tokens(3), np.random.default_rng(3).uniform(0, 1, (B, 10))
    rewards = rewards.astype(np.float32)
    jl, jgrad = jax.value_and_grad(jsg.pg_loss)(jg, jnp.asarray(samples), jnp.asarray(rewards),
                                                JG)
    live = jax.tree.map(lambda t: t.requires_grad_(True), tg)
    tr = torch.from_numpy(rewards).requires_grad_(True)
    tl = tsg.pg_loss(live, torch.from_numpy(samples), tr, TG)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), abs=ATOL)
    assert tr.grad is None  # the rewards are constants
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.grad.numpy(), live)),
                    jax.tree.leaves(_np(jgrad))):
        np.testing.assert_allclose(a, b, atol=ATOL)


# ---------------------------------------------------------------------------
# The trainer: one update of each phase from a shared state
# ---------------------------------------------------------------------------

CFG = dict(batch_size=B, generated_num=8, rollout_num=3)
D_GRAD = jax.jit(jax.value_and_grad(jsg.discriminator_loss), static_argnums=3)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """A JAX trainer one MLE step and one D step in (non-zero Adam moments),
    and a port trainer restored from a JAX checkpoint of its state."""
    jt = jtrain.SeqGanTrainer(jtrain.SeqGanConfig(g=JG, d=JD, **CFG), seed=0)
    jt.g_params, jt.g_opt, _ = jt._mle_step(jt.g_params, jt.g_opt, jnp.asarray(_tokens(4)))
    labels = jnp.asarray([1, 0, 0, 1])
    grads = D_GRAD(jt.d_params, jnp.asarray(_tokens(5)), labels, JD, None)[1]
    up, jt.d_opt = jt.d_tx.update(grads, jt.d_opt)
    jt.d_params = optax.apply_updates(jt.d_params, up)
    path = tmp_path_factory.mktemp("seqgan_state")
    keys = ("oracle_params", "g_params", "g_opt", "d_params", "d_opt")
    jck.save(path, 0, {k: getattr(jt, k) for k in keys})
    return jt, path, keys


def _port_trainer(shared):
    jt, path, keys = shared
    tt = ttrain.SeqGanTrainer(ttrain.SeqGanConfig(g=TG, d=TD, **CFG), seed=0, device="cpu")
    state = tck.restore(path, {k: getattr(tt, k) for k in keys})
    for k in keys:
        setattr(tt, k, state[k])
    assert_tree_close({k: state[k] for k in keys}, {k: getattr(jt, k) for k in keys}, rel=0)
    return tt


def test_mle_step_matches_jax(shared):
    jt = shared[0]
    tt = _port_trainer(shared)
    toks = _tokens(6)
    g, opt, loss = jt._mle_step(jt.g_params, jt.g_opt, jnp.asarray(toks))
    assert float(tt.mle_step(torch.from_numpy(toks).long())) == pytest.approx(float(loss),
                                                                               abs=ATOL)
    assert_tree_close({"g": tt.g_params, "opt": tt.g_opt}, {"g": g, "opt": opt})


def test_d_step_matches_jax(shared):
    jt = shared[0]
    tt = _port_trainer(shared)
    toks, labels, dk = _tokens(7), np.array([0, 1, 1, 0], np.int32), jax.random.PRNGKey(9)
    loss, grads = D_GRAD(jt.d_params, jnp.asarray(toks), jnp.asarray(labels), JD, dk)
    up, opt = jt.d_tx.update(grads, jt.d_opt)
    d = optax.apply_updates(jt.d_params, up)
    tl = tt.d_step(torch.from_numpy(toks), torch.from_numpy(labels),
                   dropout_mask=keep_mask(dk, JD.dropout, (B, JD.feature_dim)))
    assert float(tl) == pytest.approx(float(loss), abs=ATOL)
    assert_tree_close({"d": tt.d_params, "opt": tt.d_opt}, {"d": d, "opt": opt})


def test_pg_step_matches_jax(shared):
    """JAX's ``_pg_step`` on a key; the port's on the noise of that key's
    splits (``k1, k2 = split(key)``: G's samples from ``k1``, the rollouts
    from ``k2``): the same rewards, loss, params and Adam state."""
    jt = shared[0]
    tt = _port_trainer(shared)
    key = jax.random.PRNGKey(13)
    g, opt, loss, rewards = jt._pg_step(jt.g_params, jt.g_opt, jt.d_params, key)
    k1, k2 = jax.random.split(key)
    tl, tr = tt.pg_step(sample_noise=gumbel(k1, 10, (B, 50)),
                        rollout_noise=gumbel(k2, 9, (3 * 9 * B, 50)))
    np.testing.assert_allclose(tr.numpy(), np.asarray(rewards), atol=ATOL)
    assert float(tl) == pytest.approx(float(loss), abs=ATOL)
    assert_tree_close({"g": tt.g_params, "opt": tt.g_opt}, {"g": g, "opt": opt})


def test_oracle_nll_matches_jax(shared):
    jt = shared[0]
    tt = _port_trainer(shared)
    key = jax.random.PRNGKey(17)
    theirs = float(jt._oracle_nll(jt.oracle_params, jt.g_params, key))
    assert tt.oracle_nll(noise=gumbel(key, 10, (B, 50))) == pytest.approx(theirs, abs=ATOL)


def test_trainer_phases_run_and_learn(shared):
    """The phases end to end on the CPU: oracle samples in range, MLE
    lowers the NLL of the positives, D and adversarial rounds give finite
    losses, and out-of-range ids are refused on the host; a model size
    that does not divide the filters is refused, a mesh of one rank taken."""
    tt = ttrain.SeqGanTrainer(ttrain.SeqGanConfig(g=TG, d=TD, **CFG), seed=1, device="cpu")
    positive = tt.oracle_samples(8)
    assert positive.shape == (8, 10) and positive.dtype == np.int32
    assert 0 <= positive.min() and positive.max() < 50
    before = float(tsg.generator_nll(tt.g_params, torch.from_numpy(positive), TG))
    tt.pretrain_generator(positive, epochs=3)
    after = float(tsg.generator_nll(tt.g_params, torch.from_numpy(positive), TG))
    assert after < before
    assert np.isfinite(tt.train_discriminator(positive, d_steps=1, epochs=1))
    g_loss, d_loss = tt.adversarial_epoch(positive, d_steps=1, d_epochs=1)
    assert np.isfinite([g_loss, d_loss, tt.oracle_nll()]).all()
    assert tt.generator_samples(5).shape == (5, 10)
    bad = positive.copy()
    bad[0, 0] = 50
    with pytest.raises(ValueError, match=r"\[0, 50\)"):
        tt.pretrain_generator(bad)
    with pytest.raises(ValueError, match="num_filters entry 8 not divisible by model axis 3"):
        ttrain.SeqGanTrainer(ttrain.SeqGanConfig(g=TG, d=TD), mesh=split_mesh(3), device="cpu")
    one = ttrain.SeqGanTrainer(ttrain.SeqGanConfig(g=TG, d=TD), mesh=make_mesh(
        MeshSpec(), device="cpu"))  # a mesh of one rank: the single-device trainer
    assert one.device == torch.device("cpu") and not one.par.tp


def test_sample_files_equal_jax(tmp_path):
    rows = _tokens(8, (5, 10))
    ttrain.write_samples(tmp_path / "t" / "s.txt", rows)
    jtrain.write_samples(tmp_path / "j" / "s.txt", rows)
    assert (tmp_path / "t" / "s.txt").read_bytes() == (tmp_path / "j" / "s.txt").read_bytes()
    back = ttrain.read_samples(tmp_path / "j" / "s.txt")
    np.testing.assert_array_equal(back, jtrain.read_samples(tmp_path / "t" / "s.txt"))
    assert back.dtype == np.int32


def test_cli_seqgan_train_on_cpu(tmp_path, monkeypatch):
    """``seqgan train --device cpu`` at a tiny vocabulary (the CLI keeps the
    shipped 1720-filter D and seq_len 20): both sample files, in range."""
    params = tmp_path / "params"
    params.mkdir()
    (params / "params.json").write_text(
        '{"vocab_size": 50, "seq_len": 20, "batch_size": 8, "emb_dim": 8, "hidden_dim": 8,'
        ' "start_token": 0, "generated_num": 8, "rollout_num": 2, "g_lr": 0.01, "d_lr": 0.01,'
        ' "pretrain_g_epochs": 1, "adversarial_rounds": 1}')
    monkeypatch.chdir(tmp_path)
    cli.main(["seqgan", "train", "--params-dir", str(params), "--device", "cpu"])
    for name in ("positive", "generated"):
        rows = ttrain.read_samples(tmp_path / "data" / "seqgan" / f"{name}.txt")
        assert rows.shape == (8, 20) and rows.min() >= 0 and rows.max() < 50
