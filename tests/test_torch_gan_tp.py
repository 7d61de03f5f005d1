"""The port's GAN parallelism pieces (music_tpu_torch.parallel.gan_tp and
rnn_tp, and the models' cross-rank collectives) on gloo ranks on the CPU,
held against the JAX package's unsharded functions on the same weights:

- the split CNN discriminator's forward on ``model=2`` and ``model=4`` for
  SeqGAN's contract and LeakGAN's (``pred``, ``feature``, ``score``), and the
  gradients of both split D losses, gathered, against ``jax.grad`` of the
  unsharded losses; with dropout on, JAX's mask is fed to both sides, and a
  split forward drawing its mask from a generator equals one device's
  drawing from the same generator;
- the gate permutation and repack of rnn_tp, element for element, and
  three hidden-split LSTM steps (``lstm_cell_tp`` on ``model=2``) against
  JAX's ``ops.rnn.lstm_cell``: the states and the gradients of the
  weights (gathered, unpacked) and of the inputs;
- C-RNN-GAN's hidden-split bi-LSTM D on ``model=2`` with and without meta:
  decisions, features, and the gradients of D's loss (D's, gathered and
  unpacked) and of G's adversarial loss (G's, through D's inputs);
- LeakGAN's reward rescale with the ``data`` group of 4 ranks against the
  rescale of the whole batch (tests/test_leakgan.py:108's cases, and tied
  sums), and C-RNN-GAN's feature matching with the ``data`` group against
  the whole batch's loss and gradient.

One spawned group of 4 ranks runs every case (``_rank_cases``); a mesh of
fewer ranks takes the first.  Tolerances (float32): forwards rtol 1e-5,
gradients rtol 1e-4, each with atol 1e-6 for values near zero."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_tpu.models import crnngan as jcg
from music_tpu.models import leakgan as jlg
from music_tpu.models import seqgan as jsg
from music_tpu.ops import rnn as jrnn
from music_tpu.parallel import gan_tp as jgan_tp
from music_tpu.parallel import rnn_tp as jrnn_tp
from music_tpu_torch.core import optim
from music_tpu_torch.models import crnngan as tcg
from music_tpu_torch.models import leakgan as tlg
from music_tpu_torch.models import seqgan as tsg
from music_tpu_torch.parallel import gan_tp, launch, rnn_tp
from music_tpu_torch.parallel.collectives import gather_from, sum_grads
from music_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)

SG_KW = dict(vocab_size=40, emb_dim=8, filter_sizes=(1, 2, 3), num_filters=(8, 8, 16),
             seq_len=10, dropout=0.25)
LG_KW = dict(vocab_size=40, seq_len=10, step_size=5, goal_size=4, worker_emb_dim=8,
             worker_hidden=8, manager_hidden=8, dis_emb_dim=8, filter_sizes=(1, 2, 3),
             num_filters=(8, 8, 16), dropout=0.2)
CG_KW = dict(noise_dim=4, hidden_dim=8, song_length=6)
J_SG, T_SG = jsg.DiscriminatorConfig(**SG_KW), tsg.DiscriminatorConfig(**SG_KW)
J_LG, T_LG = jlg.LeakGanConfig(**LG_KW), tlg.LeakGanConfig(**LG_KW)
B, F = 6, 32
CB = 4  # C-RNN-GAN batch (a data=4 mesh: one row a rank)
META = 3
CONTRACTS = ("seqgan", "leakgan")
TP_SIZES = (2, 4)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _draw(like, seed: int, scale: float = 0.3):
    """A tree of the structure and shapes of ``like`` (the port's init),
    every leaf uniform in ``(-scale, scale)`` from a numpy seed (biases
    nonzero, so that their gradients are checked)."""
    rng = np.random.default_rng(seed)
    return optim.tree_map(lambda x: rng.uniform(-scale, scale, tuple(x.shape)).astype(np.float32),
                          like)


def _cnn_inputs():
    """Both contracts' D params, tokens (LeakGAN's with the pad id) and
    labels, from numpy seeds."""
    gen = torch.Generator().manual_seed(0)
    return {
        "seqgan": _draw(tsg.init_discriminator(gen, T_SG), 0),
        "leakgan": _draw(tlg.init_discriminator(gen, T_LG), 1),
        "tokens": {"seqgan": np.random.default_rng(1).integers(0, 40, (B, 10)).astype(np.int32),
                   "leakgan": np.random.default_rng(1).integers(0, 41, (B, 10)).astype(np.int32)},
        "labels": np.array([0, 1, 1, 0, 1, 0], np.int32),
    }


def _mask(contract):
    cfg = J_SG if contract == "seqgan" else J_LG
    return np.asarray(jax.random.bernoulli(jax.random.PRNGKey(7), 1.0 - cfg.dropout, (B, F)))


def _cg_cfgs(meta_dim):
    return jcg.CRnnGanConfig(**CG_KW, meta_dim=meta_dim), tcg.CRnnGanConfig(**CG_KW,
                                                                          meta_dim=meta_dim)


def _cg_inputs(meta_dim):
    _, tc = _cg_cfgs(meta_dim)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(meta_dim)
    return {
        "g": _draw(tcg.init_generator(gen, tc), 10 + meta_dim),
        "d": _draw(tcg.init_discriminator(gen, tc), 20 + meta_dim),
        "real": rng.normal(0, 1, (CB, 6, 4)).astype(np.float32),
        "fake": rng.normal(0, 1, (CB, 6, 4)).astype(np.float32),
        "meta": (rng.uniform(0, 1, (CB, meta_dim)) > 0.5).astype(np.float32) if meta_dim else None,
        "noise": np.asarray(jax.random.uniform(jax.random.PRNGKey(9), (6, CB, 4))),
    }


def _rescale_sums():
    """[n_goals, B] sums: distinct values (tests/test_leakgan.py:108), and
    ties that a stable sort must rank by global index."""
    distinct = np.random.default_rng(0).permutation(32).reshape(2, 16).astype(np.float32)
    tied = np.round(np.random.default_rng(1).uniform(0, 1, (2, 16)), 1).astype(np.float32)
    return {"distinct": distinct, "tied": tied}


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _on(shape):
    return make_mesh(MeshSpec(*shape), ranks=range(int(np.prod(shape))), device="cpu")


def _cnn_case(contract, mesh, inputs):
    """The split forward (JAX's mask), its loss's gathered gradients, and the
    forward with a mask drawn from a generator against one device's."""
    cfg = T_SG if contract == "seqgan" else T_LG
    group, m = mesh.group("model"), mesh.shape["model"]
    specs = gan_tp.discriminator_specs(cfg)
    whole = tsg.params_from_numpy(inputs[contract])
    local = gan_tp.shard_tree(mesh, whole, specs)
    tokens, labels = _t(inputs["tokens"][contract]), _t(inputs["labels"])
    mask = _t(_mask(contract))
    leak = contract == "leakgan"
    fwd = functools.partial(gan_tp.discriminator_forward_tp, post_highway_feature=leak,
                            softmax_pred=leak)
    out = {}
    plain = fwd(local, tokens, cfg, group)
    dropped = fwd(local, tokens, cfg, group, dropout_mask=mask)
    out["forward"] = {k: v.numpy() for k, v in plain.items()}
    out["dropout"] = {k: v.numpy() for k, v in dropped.items()}
    loss_fn = gan_tp.leakgan_dis_loss_tp if leak else gan_tp.seqgan_dis_loss_tp
    live = optim.live(local)
    loss = loss_fn(live, tokens, labels, cfg, group, dropout_mask=mask)
    grads = gan_tp.gather_tree(mesh, optim.tree_grads(loss, live), specs)
    out["loss"] = (float(loss.detach()), optim.tree_map(lambda g: g.numpy(), grads))
    split = fwd(local, tokens, cfg, group, dropout_generator=torch.Generator().manual_seed(5))
    single = (tlg if leak else tsg).discriminator_forward(
        whole, tokens, cfg, dropout_generator=torch.Generator().manual_seed(5))
    out["generator"] = max(float((split[k] - single[k]).abs().max()) for k in single)
    assert m == mesh.size("model")
    return out


def _crnngan_case(mesh, meta_dim, inputs):
    """The hidden-split D's forward, D's loss gradients (gathered, unpacked)
    and G's adversarial loss gradients through it."""
    _, tc = _cg_cfgs(meta_dim)
    group, m = mesh.group("model"), mesh.shape["model"]
    specs = gan_tp.crnngan_d_specs()
    g = tcg.params_from_numpy(inputs["g"])
    local = gan_tp.shard_tree(mesh, gan_tp.repack_crnngan_d(tcg.params_from_numpy(inputs["d"]),
                                                            m), specs)
    d_fwd = functools.partial(gan_tp.crnngan_forward_tp, group=group)
    real, fake, meta = _t(inputs["real"]), _t(inputs["fake"]), _t(inputs["meta"])
    p, f = d_fwd(local, real, tc, meta)
    live = optim.live(local)
    loss = tcg.d_loss(live, real, fake, tc, meta=meta, d_forward=d_fwd)
    d_grads = gan_tp.unpack_crnngan_d(gan_tp.gather_tree(mesh, optim.tree_grads(loss, live),
                                                         specs), m)
    g_live = optim.live(g)
    g_loss = tcg.g_adv_loss(g_live, local, CB, tc, meta, noise=_t(inputs["noise"]),
                            d_forward=d_fwd)
    g_grads = optim.tree_grads(g_loss, g_live)
    as_np = functools.partial(optim.tree_map, lambda x: x.detach().numpy())
    return {"forward": (p.detach().numpy(), f.detach().numpy()),
            "d_loss": (float(loss.detach()), as_np(d_grads)),
            "g_adv_loss": (float(g_loss.detach()), as_np(g_grads))}


def _fm_case(mesh, inputs):
    """Feature matching on this rank's rows with the ``data`` group (and the
    split D on a model axis): the loss and G's gradients summed."""
    _, tc = _cg_cfgs(META)
    m = mesh.shape["model"]
    rows = slice(mesh.index("data") * (CB // mesh.shape["data"]),
                 (mesh.index("data") + 1) * (CB // mesh.shape["data"]))
    d = tcg.params_from_numpy(inputs["d"])
    d_fwd = None
    if m > 1:
        d = gan_tp.shard_tree(mesh, gan_tp.repack_crnngan_d(d, m), gan_tp.crnngan_d_specs())
        d_fwd = functools.partial(gan_tp.crnngan_forward_tp, group=mesh.group("model"))
    g_live = optim.live(tcg.params_from_numpy(inputs["g"]))
    loss = tcg.g_feature_matching_loss(g_live, d, _t(inputs["real"])[rows], tc,
                                       _t(inputs["meta"])[rows],
                                       noise=_t(inputs["noise"])[:, rows], d_forward=d_fwd,
                                       group=mesh.group("data"))
    grads = sum_grads(optim.tree_grads(loss, g_live), mesh)
    return float(loss.detach()), optim.tree_map(lambda x: x.numpy(), grads)


CELL_B, CELL_IN, CELL_H, CELL_STEPS = 3, 5, 8, 3


def _cell_inputs():
    """An LSTM's parameters, three steps' inputs and the initial state."""
    rng = np.random.default_rng(30)
    draw = lambda *shape: rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    return {"params": {"wi": draw(CELL_IN, 4 * CELL_H), "wh": draw(CELL_H, 4 * CELL_H),
                       "bi": draw(4 * CELL_H), "bh": draw(4 * CELL_H)},
            "xs": draw(CELL_STEPS, CELL_B, CELL_IN), "h": draw(CELL_B, CELL_H),
            "c": draw(CELL_B, CELL_H)}


def _cell_case(mesh, inputs):
    """Three ``lstm_cell_tp`` steps from this rank's repacked columns: the
    final ``h`` and ``c`` (gathered), and the gradients of their sum of
    squares for the weights (gathered, unpacked) and the inputs."""
    group, m = mesh.group("model"), mesh.shape["model"]
    s, Hl = mesh.index("model"), CELL_H // m
    local = gan_tp.shard_tree(mesh, rnn_tp.repack_lstm_params(
        {k: torch.from_numpy(v) for k, v in inputs["params"].items()}, m), rnn_tp.lstm_specs())
    live = optim.live(local)
    xs = torch.from_numpy(inputs["xs"]).requires_grad_(True)
    h, c = torch.from_numpy(inputs["h"]), torch.from_numpy(inputs["c"][:, s * Hl:(s + 1) * Hl])
    for t in range(CELL_STEPS):
        h, c = rnn_tp.lstm_cell_tp(live, xs[t], (h, c), group)
    c_full = gather_from(c, group, -1)
    loss = (h ** 2).sum() + (c_full ** 2).sum()
    grads = optim.tree_grads(loss, {"params": live, "xs": xs})
    params = rnn_tp.unpack_lstm_params(
        gan_tp.gather_tree(mesh, grads["params"], rnn_tp.lstm_specs()), m)
    return {"h": h.detach().numpy(), "c": c_full.detach().numpy(),
            "grads": {"params": optim.tree_map(lambda g: g.numpy(), params),
                      "xs": grads["xs"].numpy()}}


def _rank_cases(cnn, cg, sums, cell):
    out = {}
    for m in TP_SIZES:
        mesh = _on((1, 1, m))
        for contract in CONTRACTS:
            out[(contract, m)] = mesh and _cnn_case(contract, mesh, cnn)
    mesh = _on((1, 1, 2))
    out["cell"] = mesh and _cell_case(mesh, cell)
    for meta_dim in (0, META):
        out[("crnngan", meta_dim)] = mesh and _crnngan_case(mesh, meta_dim, cg[meta_dim])
    mesh = _on((4, 1, 1))
    for name, s in sums.items():
        b = s.shape[1] // 4
        local = torch.from_numpy(s[:, mesh.index("data") * b:(mesh.index("data") + 1) * b])
        out[("rescale", name)] = tlg.rescale_rewards(local, group=mesh.group("data")).numpy()
    for shape in ((4, 1, 1), (2, 1, 2)):
        mesh = _on(shape)
        out[("fm", shape)] = mesh and _fm_case(mesh, cg[META])
    return out


@pytest.fixture(scope="module")
def run():
    cnn, cg, sums = _cnn_inputs(), {k: _cg_inputs(k) for k in (0, META)}, _rescale_sums()
    cell = _cell_inputs()
    ranks = launch.run(_rank_cases, 4, (cnn, cg, sums, cell))
    return {"cnn": cnn, "cg": cg, "sums": sums, "cell": cell, "ranks": ranks}


def _results(run, key, n_ranks):
    got = [r[key] for r in run["ranks"] if r[key] is not None]
    assert len(got) == n_ranks
    return got


def _close_tree(ours, theirs, **tol):
    theirs = _np(theirs)
    assert jax.tree.structure(jax.tree.map(np.asarray, ours)) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        np.testing.assert_allclose(a, b, **tol)


def _jax_forward(contract, inputs, dropout=False):
    """JAX's unsharded forward of either contract (with its dropout key)."""
    params = jax.tree.map(jnp.asarray, inputs[contract])
    tokens = jnp.asarray(inputs["tokens"][contract])
    dkey = jax.random.PRNGKey(7) if dropout else None
    if contract == "seqgan":
        return jsg.discriminator_forward(params, tokens, J_SG, dropout_key=dkey)
    return jlg.discriminator_forward(params, tokens, J_LG, dropout_key=dkey)


@pytest.mark.parametrize("m", TP_SIZES)
@pytest.mark.parametrize("contract", CONTRACTS)
def test_discriminator_forward_matches_jax_unsharded(run, contract, m):
    """``pred``, ``feature`` and ``score`` of the split forward on every
    rank against JAX's unsharded ``discriminator_forward``."""
    ref = _jax_forward(contract, run["cnn"])
    for got in _results(run, (contract, m), m):
        for k in ("pred", "feature", "score"):
            np.testing.assert_allclose(got["forward"][k], np.asarray(ref[k]), **FWD, err_msg=k)


def _jax_loss(contract, inputs):
    loss = jsg.discriminator_loss if contract == "seqgan" else jlg.dis_loss
    cfg = J_SG if contract == "seqgan" else J_LG
    return jax.jit(jax.value_and_grad(loss), static_argnums=3)(
        inputs[contract], inputs["tokens"][contract], inputs["labels"], cfg,
        jax.random.PRNGKey(7))


@pytest.mark.parametrize("m", TP_SIZES)
@pytest.mark.parametrize("contract", CONTRACTS)
def test_split_loss_gradients_match_jax_grad(run, contract, m):
    """The split D loss (JAX's dropout mask fed) and its gradients, gathered
    whole, against ``jax.value_and_grad`` of the unsharded loss with JAX's
    dropout key; LeakGAN's L2 sums the split head's squares over ``model``."""
    ref_loss, ref_grads = _jax_loss(contract, run["cnn"])
    for loss, grads in (r["loss"] for r in _results(run, (contract, m), m)):
        assert loss == pytest.approx(float(ref_loss), rel=1e-5)
        _close_tree(grads, ref_grads, **GRAD)


@pytest.mark.parametrize("m", TP_SIZES)
@pytest.mark.parametrize("contract", CONTRACTS)
def test_dropout_mask_is_the_single_device_mask(run, contract, m):
    """With dropout on: JAX's whole mask (``bernoulli`` of its key) fed to
    the split forward gives JAX's forward with that key (LeakGAN's leaked
    feature, taken after dropout, too), and a mask drawn whole from a
    generator equals one device's draw from the same generator."""
    ref = _jax_forward(contract, run["cnn"], dropout=True)
    for got in _results(run, (contract, m), m):
        for k in ("pred", "feature", "score"):
            np.testing.assert_allclose(got["dropout"][k], np.asarray(ref[k]), **FWD, err_msg=k)
        assert got["generator"] < 1e-5


@pytest.mark.parametrize("m", TP_SIZES)
def test_gate_permutation_and_repack_equal_jax(m):
    """``_gate_perm``, ``repack_lstm_params`` and the C-RNN-GAN repack equal
    JAX's element for element; unpacking inverts them exactly."""
    H = 8
    np.testing.assert_array_equal(rnn_tp._gate_perm(H, m), jrnn_tp._gate_perm(H, m))
    d = _cg_inputs(META)["d"]
    ours = gan_tp.repack_crnngan_d(tcg.params_from_numpy(d), m)
    _close_tree(optim.tree_map(lambda x: x.numpy(), ours), jgan_tp.repack_crnngan_d(d, m),
                rtol=0, atol=0)
    lstm = tcg.params_from_numpy(d["fwd1"])
    _close_tree(optim.tree_map(lambda x: x.numpy(), rnn_tp.repack_lstm_params(lstm, m)),
                jrnn_tp.repack_lstm_params(d["fwd1"], m), rtol=0, atol=0)
    back = gan_tp.unpack_crnngan_d(ours, m)
    _close_tree(optim.tree_map(lambda x: x.numpy(), back), d, rtol=0, atol=0)
    with pytest.raises(ValueError, match="hidden 8 not divisible by model axis 3"):
        rnn_tp.repack_lstm_params(lstm, 3)


def test_lstm_cell_tp_matches_jax_cell(run):
    """Three hidden-split steps on ``model=2`` against JAX's
    ``ops.rnn.lstm_cell`` on the unpacked weights: ``h`` (whole on each
    rank), ``c`` (gathered) and the gradients of their sum of squares."""
    inputs = run["cell"]

    @jax.jit
    def reference(params, xs, h, c):
        def loss(params, xs):
            state = (h, c)
            for t in range(CELL_STEPS):
                state = jrnn.lstm_cell(params, xs[t], state)
            return (state[0] ** 2).sum() + (state[1] ** 2).sum(), state
        (_, state), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, xs)
        return state, {"params": grads[0], "xs": grads[1]}

    (h, c), grads = reference(inputs["params"], inputs["xs"], inputs["h"], inputs["c"])
    for got in _results(run, "cell", 2):
        np.testing.assert_allclose(got["h"], np.asarray(h), **FWD)
        np.testing.assert_allclose(got["c"], np.asarray(c), **FWD)
        _close_tree(got["grads"], grads, **GRAD)


def _jax_crnngan(meta_dim, inputs):
    """JAX's forward, D loss and G adversarial loss with their gradients, in
    one jitted program."""
    jc, _ = _cg_cfgs(meta_dim)

    @jax.jit
    def reference(g, d, real, fake, meta):
        meta = None if meta_dim == 0 else meta
        return {
            "forward": jcg.discriminator_forward(d, real, jc, meta=meta),
            "d_loss": jax.value_and_grad(jcg.d_loss)(d, real, fake, jc, meta=meta),
            "g_adv_loss": jax.value_and_grad(
                lambda gp: jcg.g_adv_loss(gp, d, jax.random.PRNGKey(9), CB, jc, meta=meta))(g),
        }

    meta = jnp.zeros((CB, 0)) if inputs["meta"] is None else inputs["meta"]
    return reference(inputs["g"], inputs["d"], inputs["real"], inputs["fake"], meta)


@pytest.mark.parametrize("meta_dim", (0, META), ids=("no meta", "meta"))
def test_crnngan_split_d_matches_jax_unsharded(run, meta_dim):
    """The hidden-split bi-LSTM D on ``model=2``: decisions and features of
    the unpacked parameters' JAX forward; D's loss and its gradients
    (gathered, unpacked to torch's gate order); G's adversarial loss and
    its gradients, which reach G through D's inputs."""
    ref = _jax_crnngan(meta_dim, run["cg"][meta_dim])
    for got in _results(run, ("crnngan", meta_dim), 2):
        for a, b in zip(got["forward"], ref["forward"]):
            np.testing.assert_allclose(a, np.asarray(b), **FWD)
        for name in ("d_loss", "g_adv_loss"):
            assert got[name][0] == pytest.approx(float(ref[name][0]), rel=1e-5), name
            _close_tree(got[name][1], ref[name][1], **GRAD)


@pytest.mark.parametrize("name", ("distinct", "tied"))
def test_rescale_ranks_over_the_global_batch(run, name):
    """Each of 4 data ranks rescales its 4 columns of the sums with the
    ``data`` group; the concatenation equals JAX's rescale of the whole
    batch (equal sums rank by global index, as ``jnp.argsort``)."""
    sums = run["sums"][name]
    got = np.concatenate([r[("rescale", name)] for r in run["ranks"]], axis=1)
    np.testing.assert_allclose(got, np.asarray(jlg.rescale_rewards(jnp.asarray(sums))),
                               rtol=1e-6, atol=0)
    local = np.asarray(jlg.rescale_rewards(jnp.asarray(sums[:, :4])))
    assert not np.allclose(local, got[:, :4])  # ranking alone would differ


@jax.jit
def _jax_fm(g, d, real, meta):
    jc, _ = _cg_cfgs(META)
    return jax.value_and_grad(lambda gp: jcg.g_feature_matching_loss(
        gp, d, jax.random.PRNGKey(9), real, jc, meta=meta))(g)


@pytest.mark.parametrize("shape", ((4, 1, 1), (2, 1, 2)), ids=("data4", "data2xmodel2"))
def test_feature_matching_averages_over_the_data_group(run, shape):
    """Feature matching on each rank's rows with the ``data`` group (and the
    split D on ``model``): every rank's loss is the whole batch's, and the
    gradients summed over ``data`` are ``jax.grad`` of it."""
    inputs = run["cg"][META]
    jc, _ = _cg_cfgs(META)
    ref_loss, ref_grads = _jax_fm(inputs["g"], inputs["d"], inputs["real"], inputs["meta"])
    for loss, grads in _results(run, ("fm", shape), 4):
        assert loss == pytest.approx(float(ref_loss), rel=1e-5)
        _close_tree(grads, ref_grads, **GRAD)
