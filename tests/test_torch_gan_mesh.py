"""The port's SeqGAN and C-RNN-GAN trainers on ``(data, seq, model)``
meshes of gloo ranks on the CPU, held against the JAX package's unsharded
steps on the global batch with the same draws (LeakGAN's:
tests/test_torch_gan_mesh_leakgan.py, on this file's helpers):

- SeqGAN (MLE, D and policy-gradient steps) and C-RNN-GAN (pretraining,
  and GAN steps through both gates: D trained with G adversarial, D frozen
  with G by feature matching) on ``data=2``, ``model=2`` and ``data=2 x
  model=2``: each rank's losses and the gathered parameters and Adam
  states after each step against JAX's loss and ``jax.grad`` update of the
  global batch (JAX's model functions and the optax chains its trainers
  build; C-RNN-GAN's step in the branch its gates take), each rank fed
  its rows of JAX's draws (Gumbel noise, dropout masks, uniforms);
- the port's own ``mesh=None`` trainer given the whole batch and draws;
- SeqGAN's steps and C-RNN-GAN's feature-matching step on ``data=2 x
  seq=2``, whose seq ranks replicate their data rank;
- C-RNN-GAN's frozen-D step on the data meshes, whose two data ranks' local
  statistics fall on either side of both gates: every rank takes the
  global decision (JAX's) and finishes;
- checkpoints: every mesh trainer resumes a checkpoint written by JAX's
  checkpoint code and holds its state exactly; C-RNN-GAN's saved from a
  ``model=2`` mesh restores into a ``mesh=None`` trainer and into JAX's
  trainer with equal leaves.

SeqGAN takes ``batch_size`` rows a data rank (JAX's global batch is
``batch_size`` times the data size); C-RNN-GAN's ``batch_size`` is the
global batch, split over ``data``, as in JAX.  The clip norms are small
enough to engage on every step, so the split norm is checked.  One spawned
group of 4 ranks runs every case (``_rank_cases``) while the JAX
references are computed.  Tolerances (float32): losses 1e-5 absolute, each
leaf within 1e-5 of its largest magnitude."""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_tpu.core import checkpoint as jck
from music_tpu.core.optim import step_lr as jstep_lr
from music_tpu.models import crnngan as jcg
from music_tpu.models import seqgan as jsg
from music_tpu.train import crnngan_train as jcgt
from music_tpu_torch.core import checkpoint as tck
from music_tpu_torch.models import crnngan as tcg
from music_tpu_torch.models import seqgan as tsg
from music_tpu_torch.parallel import gan_tp, launch
from music_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from music_tpu_torch.train import crnngan_train as tcgt
from music_tpu_torch.train import seqgan_train as tsgt
from test_torch_seqgan import gumbel, keep_mask, leaves_by_path
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-5
MESHES = [(2, 1, 1), (1, 1, 2), (2, 1, 2)]
MESH_IDS = ["data2", "model2", "data2xmodel2"]
SEQ_MESH = (2, 2, 1)  # seq ranks replicate their data rank, as in JAX's GAN trainers
GB = 4  # the global batch of every step
CLIP = 0.05


def _rows(shape, index, n):
    """Data index ``index``'s block of ``n`` global rows on a mesh ``shape``."""
    per = n // shape[0]
    return slice(index * per, (index + 1) * per)


def _streams(noise, index, shape, lead):
    """Data index ``index``'s streams of rollout noise ``[steps, N, V]``
    whose streams are laid out ``(*lead, B)``."""
    steps, _, V = noise.shape
    n = noise.reshape(steps, *lead, -1, V)
    return n[..., _rows(shape, index, n.shape[-2]), :].reshape(steps, -1, V)


def _np_tree(tree):
    """A port state as ``{key path: numpy array}``."""
    return {p: np.array(v) for p, v in leaves_by_path(tree, False).items()}


def _to_jax(port_state, example):
    """The port's state in the structure of JAX's ``example`` (its leaves in
    the same order: the checkpoints' key paths)."""
    leaves = [np.array(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
              for _, v in tck._flatten(port_state)]
    return jax.tree.unflatten(jax.tree.structure(example), leaves)


def _on(shape):
    return make_mesh(MeshSpec(*shape), ranks=range(int(np.prod(shape))), device="cpu")


def _tokens(seed, hi, shape):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(np.int32)


def _jax_tx(lr, **sched):
    """The optax chain of JAX's GAN trainers: the clip, then Adam (on a
    ``step_lr`` schedule for LeakGAN)."""
    lr = jstep_lr(lr, sched["step"], sched["rate"]) if sched else lr
    return optax.chain(optax.clip_by_global_norm(CLIP), optax.adam(lr))


# ---------------------------------------------------------------------------
# SeqGAN
# ---------------------------------------------------------------------------

SG_G = dict(vocab_size=50, emb_dim=8, hidden_dim=8, seq_len=10)
SG_D = dict(vocab_size=50, emb_dim=8, filter_sizes=(1, 2, 3), num_filters=(8, 8, 8), seq_len=10)
SG_TRAIN = dict(generated_num=8, rollout_num=2, grad_clip=CLIP)
JSG_G, JSG_D = jsg.GeneratorConfig(**SG_G), jsg.DiscriminatorConfig(**SG_D)
TSG = dict(g=tsg.GeneratorConfig(**SG_G), d=tsg.DiscriminatorConfig(**SG_D))
SG_KEYS = ("oracle_params", "g_params", "g_opt", "d_params", "d_opt")
SG_TX = _jax_tx(tsgt.SeqGanConfig().g_lr)  # g_lr == d_lr


def _seqgan_port_state(tt):
    """A port SeqGAN trainer's state with D gathered whole (every rank)."""
    gather = functools.partial(tt.par.gather, specs=tt.d_specs)
    return {"oracle_params": tt.oracle_params, "g_params": tt.g_params, "g_opt": tt.g_opt,
            "d_params": gather(tt.d_params), "d_opt": gan_tp.map_param_trees(tt.d_opt, gather)}


def _seqgan_setup(tmp):
    """A state one MLE and one D step in (non-zero Adam moments), written by
    JAX's checkpoint code; the draws of the MLE, D and PG steps."""
    tt = tsgt.SeqGanTrainer(tsgt.SeqGanConfig(**TSG, batch_size=GB, **SG_TRAIN), seed=0,
                            device="cpu")
    tt.mle_step(torch.from_numpy(_tokens(1, 50, (GB, 10))))
    tt.d_step(torch.from_numpy(_tokens(2, 50, (GB, 10))), torch.tensor([1, 0, 0, 1]))
    g, d = (tsg.params_to_numpy(p) for p in (tt.g_params, tt.d_params))
    example = {"oracle_params": g, "g_params": g, "g_opt": SG_TX.init(g), "d_params": d,
               "d_opt": SG_TX.init(d)}
    state = _to_jax(_seqgan_port_state(tt), example)
    jck.save(tmp / "seqgan", 0, state)
    dkey, key = jax.random.PRNGKey(3), jax.random.PRNGKey(4)
    k1, k2 = jax.random.split(key)
    draws = {
        "mle": _tokens(5, 50, (GB, 10)), "d": _tokens(6, 50, (GB, 10)),
        "labels": np.array([0, 1, 1, 0], np.int32),
        "mask": keep_mask(dkey, JSG_D.dropout, (GB, JSG_D.feature_dim)).numpy(),
        "sample_noise": gumbel(k1, 10, (GB, 50)).numpy(),
        "rollout_noise": gumbel(k2, 9, (2 * 9 * GB, 50)).numpy(),
    }
    return state, draws, (dkey, key)


@jax.jit
def _jsg_mle(g, opt, tokens):
    loss, grads = jax.value_and_grad(jsg.generator_nll)(g, tokens, JSG_G)
    up, opt = SG_TX.update(grads, opt)
    return optax.apply_updates(g, up), opt, loss


@jax.jit
def _jsg_d(d, opt, tokens, labels, dkey):
    loss, grads = jax.value_and_grad(jsg.discriminator_loss)(d, tokens, labels, JSG_D, dkey)
    up, opt = SG_TX.update(grads, opt)
    return optax.apply_updates(d, up), opt, loss


@jax.jit
def _jsg_pg(g, opt, d, key):
    """JAX's ``pg_step_impl`` on one device: G's samples, rollout rewards,
    the surrogate loss and its update."""
    k1, k2 = jax.random.split(key)
    samples = jsg.generate(g, k1, JSG_G, GB)
    rewards = jsg.rollout_rewards(g, d, samples, k2, g_cfg=JSG_G, d_cfg=JSG_D,
                                  rollout_num=SG_TRAIN["rollout_num"])
    loss, grads = jax.value_and_grad(jsg.pg_loss)(g, samples, rewards, JSG_G)
    up, opt = SG_TX.update(grads, opt)
    return optax.apply_updates(g, up), opt, loss, rewards


def _seqgan_reference(state, draws, keys):
    """JAX's unsharded MLE, D and PG steps in sequence from ``state``."""
    dkey, key = keys
    out = {}
    g, g_opt, loss = _jsg_mle(state["g_params"], state["g_opt"], draws["mle"])
    out["mle"] = (float(loss), {**state, "g_params": g, "g_opt": g_opt})
    d, d_opt, loss = _jsg_d(state["d_params"], state["d_opt"], draws["d"], draws["labels"], dkey)
    out["d"] = (float(loss), {**out["mle"][1], "d_params": d, "d_opt": d_opt})
    g, g_opt, loss, rewards = _jsg_pg(g, g_opt, d, key)
    out["pg"] = (float(loss), {**out["d"][1], "g_params": g, "g_opt": g_opt},
                 np.asarray(rewards))
    return out


def _seqgan_trainer(path, batch, mesh=None):
    """A port trainer (``batch`` rows a data rank) holding the checkpoint's
    state, D split over the mesh's ``model`` axis."""
    tt = tsgt.SeqGanTrainer(tsgt.SeqGanConfig(**TSG, batch_size=batch, **SG_TRAIN), seed=0,
                            mesh=mesh, device="cpu")
    state = tck.restore(path, _seqgan_port_state(tt))
    shard = functools.partial(tt.par.shard, specs=tt.d_specs)
    tt.oracle_params, tt.g_params, tt.g_opt = (state[k] for k in SG_KEYS[:3])
    tt.d_params = shard(state["d_params"])
    tt.d_opt = gan_tp.map_param_trees(state["d_opt"], shard)
    return tt


def _seqgan_steps(tt, draws, shape, index):
    """MLE, D and PG steps on this rank's rows of the draws: each step's
    loss and the state after it (PG: and this rank's rewards)."""
    t, rows = torch.from_numpy, _rows(shape, index, GB)
    out = {"resumed": _np_tree(_seqgan_port_state(tt))}
    loss = tt.mle_step(t(draws["mle"][rows]))
    out["mle"] = (float(loss), _np_tree(_seqgan_port_state(tt)))
    loss = tt.d_step(t(draws["d"][rows]), t(draws["labels"][rows]),
                     dropout_mask=t(draws["mask"][rows]))
    out["d"] = (float(loss), _np_tree(_seqgan_port_state(tt)))
    loss, rewards = tt.pg_step(sample_noise=t(draws["sample_noise"][:, rows]),
                               rollout_noise=t(_streams(draws["rollout_noise"], index, shape,
                                                        (2, 9))))
    out["pg"] = (float(loss), _np_tree(_seqgan_port_state(tt)), rewards.numpy())
    return out


def _seqgan_case(mesh, shape, tmp, draws):
    tt = _seqgan_trainer(tmp / "seqgan", GB // shape[0], mesh)
    return _seqgan_steps(tt, draws, shape, mesh.index("data"))


# ---------------------------------------------------------------------------
# C-RNN-GAN
# ---------------------------------------------------------------------------

CG_KW = dict(noise_dim=4, hidden_dim=8, song_length=6, meta_dim=3)
CG_TRAIN = dict(batch_size=GB, grad_clip=CLIP)
JCG, TCG = jcg.CRnnGanConfig(**CG_KW), tcg.CRnnGanConfig(**CG_KW)
TRAINED = "trained, adv"  # D trained, G adversarial: gates that always pass
FROZEN = "frozen, fm"  # D frozen, G by feature matching: the data ranks disagree locally
TRAINED_GATES = dict(d_too_strong=1.01, feature_matching_below=-1.0)


def _events(seed, n=GB):
    return np.random.default_rng(seed).normal(0, 1, (n, 6, 4)).astype(np.float32)


def _meta(seed, n=GB):
    return (np.random.default_rng(seed).uniform(0, 1, (n, 3)) > 0.5).astype(np.float32)


def _uniform(key):
    return np.asarray(jax.random.uniform(key, (6, GB, 4)))


CG_TX = _jax_tx(tcgt.CRnnGanTrainConfig().g_lr)  # g_lr == d_lr


def _crnngan_setup(tmp):
    """A state one pretraining and one GAN step in (D's head then shifted so
    that its decisions on the GAN step's real rows straddle 0.5 between the
    two data halves: at this state all lie just below), written by JAX's
    checkpoint code; the draws of a pretraining step and of a GAN step."""
    tt = tcgt.CRnnGanTrainer(tcgt.CRnnGanTrainConfig(cfg=TCG, **CG_TRAIN, **TRAINED_GATES),
                             seed=0, device="cpu")
    tt.pre_step(torch.from_numpy(_events(8)), torch.from_numpy(_meta(8)),
                generator=torch.Generator().manual_seed(8))
    tt.gan_step(torch.from_numpy(_events(9)), torch.from_numpy(_meta(9)),
                generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        p_real = tcg.discriminator_forward(tt.d_params, torch.from_numpy(_events(11)), TCG,
                                           torch.from_numpy(_meta(11)))[0].double()
        logit = torch.log(p_real / (1 - p_real))
        tt.d_params["out"]["b"] -= float(logit[:2].median() + logit[2:].median()) / 2
    g, d = tcg.params_to_numpy(tt.g_params), tcg.params_to_numpy(tt.d_params)
    state = _to_jax(tt.state(), {"g_params": g, "d_params": d, "g_opt": CG_TX.init(g),
                                 "d_opt": CG_TX.init(d)})
    jck.save(tmp / "crnngan", 2, state)
    pre_key, gan_key = jax.random.PRNGKey(10), jax.random.PRNGKey(11)
    draws = {"pre": (_events(10), _meta(10), _uniform(pre_key)[None]), "pre_key": pre_key,
             "gan": (_events(11), _meta(11),
                     np.stack([_uniform(k) for k in jax.random.split(gan_key, 3)])),
             "gan_key": gan_key}
    return state, draws


@jax.jit
def _jcg_pre(g, opt, real, meta, key):
    loss, grads = jax.value_and_grad(jcg.g_pretrain_loss)(g, key, real, JCG, meta)
    up, opt = CG_TX.update(grads, opt)
    return optax.apply_updates(g, up), opt, loss


@functools.partial(jax.jit, static_argnums=0)
def _jcg_gan(trained, g, d, g_opt, d_opt, real, meta, key):
    """JAX's single-program GAN step (``gan_single_impl``) in one branch of
    its gates: D trained and G adversarial, or D frozen and G by feature
    matching.  Returns the state, G's and D's losses and D's accuracy."""
    k1, k2, k3 = jax.random.split(key, 3)
    fake = jcg.generate(g, k1, JCG, real.shape[0], meta=meta)
    p_real, _ = jcg.discriminator_forward(d, real, JCG, meta=meta)
    p_fake, _ = jcg.discriminator_forward(d, fake, JCG, meta=meta)
    d_acc = 0.5 * (jnp.mean(p_real > 0.5) + jnp.mean(p_fake < 0.5))
    dl, grads = jax.value_and_grad(lambda dp: jcg.d_loss(dp, real, fake, JCG, meta=meta))(d)
    if trained:
        up, d_opt = CG_TX.update(grads, d_opt)
        d = optax.apply_updates(d, up)
        gl, grads = jax.value_and_grad(
            lambda gp: jcg.g_adv_loss(gp, d, k3, real.shape[0], JCG, meta=meta))(g)
    else:
        gl, grads = jax.value_and_grad(
            lambda gp: jcg.g_feature_matching_loss(gp, d, k2, real, JCG, meta=meta))(g)
    up, g_opt = CG_TX.update(grads, g_opt)
    state = {"g_params": optax.apply_updates(g, up), "d_params": d, "g_opt": g_opt,
             "d_opt": d_opt}
    return state, gl, dl, d_acc


def _split_gates(path, draws):
    """Gate thresholds at which the two data halves' local statistics (2
    rows each) fall on either side of both gates while the whole batch's
    decide: D frozen (the global accuracy at or above ``d_too_strong``, one
    half's below) and G by feature matching (the global mean decision on
    the fakes below ``feature_matching_below``, one half's above).  Returns
    the thresholds and the halves' ``(accuracies, mean decisions)``."""
    tt = tcgt.CRnnGanTrainer(tcgt.CRnnGanTrainConfig(cfg=TCG, **CG_TRAIN), seed=0, device="cpu")
    assert tt.restore(path) == 2
    real, meta, noise = (torch.from_numpy(x) for x in draws["gan"])
    acc, mpf = [], []
    with torch.no_grad():
        for rows in (slice(0, 2), slice(2, 4)):
            fake = tcg.generate(tt.g_params, TCG, 2, meta=meta[rows], noise=noise[0][:, rows])
            p_real = tcg.discriminator_forward(tt.d_params, real[rows], TCG, meta[rows])[0]
            p_fake = tcg.discriminator_forward(tt.d_params, fake, TCG, meta[rows])[0]
            acc.append(float(0.5 * ((p_real > 0.5).float().mean()
                                    + (p_fake < 0.5).float().mean())))
            mpf.append(float(p_fake.mean()))
    assert acc[0] != acc[1] and mpf[0] != mpf[1], (acc, mpf)
    return {"d_too_strong": (min(acc) + float(np.mean(acc))) / 2,
            "feature_matching_below": (max(mpf) + float(np.mean(mpf))) / 2}, (acc, mpf)


def _crnngan_reference(state, draws):
    """JAX's unsharded pretraining step and GAN step in each gate branch,
    from ``state``."""
    real, meta, _ = draws["pre"]
    g, g_opt, loss = _jcg_pre(state["g_params"], state["g_opt"], real, meta, draws["pre_key"])
    out = {"pre": (float(loss), {**state, "g_params": g, "g_opt": g_opt})}
    real, meta, _ = draws["gan"]
    for name in (TRAINED, FROZEN):
        new, gl, dl, d_acc = _jcg_gan(name == TRAINED, state["g_params"], state["d_params"],
                                      state["g_opt"], state["d_opt"], real, meta,
                                      draws["gan_key"])
        out[name] = ((float(gl), float(dl), float(d_acc)), new)
    return out


def _crnngan_case(mesh, shape, tmp, draws, configs):
    """From the checkpoint, in each gate configuration: a GAN step on this
    rank's rows (the first configuration a pretraining step too, from the
    checkpoint again); the losses, the state after each, the branches.
    ``mesh=None``: one device on every row."""
    t = lambda x: torch.from_numpy(np.array(x))  # JAX's draws are read-only
    rows = _rows(shape, 0 if mesh is None else mesh.index("data"), GB)
    out = {}
    for name, gates in configs.items():
        tt = tcgt.CRnnGanTrainer(tcgt.CRnnGanTrainConfig(cfg=TCG, **CG_TRAIN, **gates), seed=0,
                                 mesh=mesh, device="cpu")
        assert tt.restore(tmp / "crnngan") == 2
        if name == TRAINED:
            out["resumed"] = _np_tree(tt.state())
            real, meta, noise = draws["pre"]
            loss = tt.pre_step(t(real[rows]), t(meta[rows]), noise=t(noise[:, :, rows]))
            out["pre"] = (float(loss), _np_tree(tt.state()))
            assert tt.restore(tmp / "crnngan") == 2
        real, meta, noise = draws["gan"]
        step = tt.gan_step(t(real[rows]), t(meta[rows]), noise=t(noise[:, :, rows]))
        out[name] = ((float(step.g_loss), float(step.d_loss), float(step.d_acc)),
                     _np_tree(tt.state()), (step.d_trained, step.feature_matching))
        if name == TRAINED and shape == (1, 1, 2):
            tt.save(tmp / "crnngan_mesh", 3)
    return out


# ---------------------------------------------------------------------------
# The group and the references
# ---------------------------------------------------------------------------


def _rank_cases(tmp, sg_draws, cg_draws, cg_configs):
    """Every case on this rank; a rank outside a case's mesh gets None."""
    out = {}
    for shape in MESHES:
        mesh = _on(shape)
        out[("seqgan", shape)] = mesh and _seqgan_case(mesh, shape, tmp, sg_draws)
        out[("crnngan", shape)] = mesh and _crnngan_case(mesh, shape, tmp, cg_draws, cg_configs)
    mesh = _on(SEQ_MESH)
    out[("seqgan", SEQ_MESH)] = _seqgan_case(mesh, SEQ_MESH, tmp, sg_draws)
    out[("crnngan", SEQ_MESH)] = _crnngan_case(mesh, SEQ_MESH, tmp, cg_draws,
                                              {FROZEN: cg_configs[FROZEN]})
    return out


def _plain(draws):
    """Draws without JAX's keys, for the ranks (which draw nothing of JAX)."""
    if isinstance(draws, dict):
        return {k: _plain(v) for k, v in draws.items() if "key" not in str(k)}
    return draws


def run_beside(rank_fn, args, references):
    """``launch.run(rank_fn, 4, args)`` in a thread while ``references()``
    (JAX's side) runs in this one: ``(the ranks' results, references())``."""
    got = {}

    def ranks_main():
        try:
            got["ranks"] = launch.run(rank_fn, 4, args)
        except BaseException as e:  # raised in the caller's thread below
            got["error"] = e

    ranks = threading.Thread(target=ranks_main)
    ranks.start()
    refs = references()
    ranks.join()
    if "error" in got:
        raise got["error"]
    return got["ranks"], refs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The states written, the ranks started on them, and JAX's unsharded
    references computed meanwhile."""
    tmp = tmp_path_factory.mktemp("gan_mesh")
    sg_state, sg_draws, sg_keys = _seqgan_setup(tmp)
    cg_state, cg_draws = _crnngan_setup(tmp)
    split, local = _split_gates(tmp / "crnngan", cg_draws)
    configs = {TRAINED: TRAINED_GATES, FROZEN: split}
    ranks, refs = run_beside(
        _rank_cases, (tmp, _plain(sg_draws), _plain(cg_draws), configs),
        lambda: {"seqgan": _seqgan_reference(sg_state, sg_draws, sg_keys),
                 "crnngan": _crnngan_reference(cg_state, cg_draws)})
    return {"tmp": tmp, "ranks": ranks, "refs": refs, "split": split, "local": local,
            "configs": configs, "states": {"seqgan": sg_state, "crnngan": cg_state},
            "draws": {"seqgan": sg_draws, "crnngan": cg_draws}}


def _mesh_results(run, trainer, shape):
    got = [r[(trainer, shape)] for r in run["ranks"] if r[(trainer, shape)] is not None]
    assert len(got) == int(np.prod(shape))
    return got


def _close(ours, ref, rel=1e-5):
    """Each leaf of ``ours`` (``{key path: array}``) within ``rel`` of the
    largest magnitude of ``ref``'s leaf at the same path (integers equal)."""
    assert list(ours) == list(ref)
    for path, want in ref.items():
        got = ours[path]
        assert got.shape == want.shape, path
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=path)
        else:
            np.testing.assert_allclose(got, want, rtol=0, err_msg=path,
                                       atol=rel * max(float(np.abs(want).max()), 1e-30))


def _close_jax(ours, jax_state, rel=1e-5):
    _close(ours, leaves_by_path(jax_state, True), rel)


def _close_losses(ours, theirs):
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(theirs, np.float64),
                               rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("phase", ["mle", "d", "pg"])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_seqgan_steps_match_jax_unsharded(run, shape, phase):
    """Each rank's loss and the gathered state after the MLE, D and PG steps
    (in that order, from the checkpoint) against JAX's steps on the global
    batch; the PG rewards of the data ranks, concatenated, against JAX's."""
    ref = run["refs"]["seqgan"][phase]
    results = _mesh_results(run, "seqgan", shape)
    for res in results:
        _close_losses(res[phase][0], ref[0])
        _close_jax(res[phase][1], ref[1])
    if phase == "pg":
        rewards = np.concatenate([res[phase][2] for res in results[::shape[2]]])
        np.testing.assert_allclose(rewards, ref[2], rtol=0, atol=ATOL)


@pytest.mark.parametrize("phase", ["pre", TRAINED, FROZEN])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_crnngan_steps_match_jax_unsharded(run, shape, phase):
    """The pretraining step, and a GAN step through each branch of both
    gates, from the checkpoint: each rank's losses and D's global accuracy,
    the branches it took, and the gathered state (D unpacked to torch's
    gate order) against JAX's single-program step on the global batch."""
    ref = run["refs"]["crnngan"][phase]
    for res in _mesh_results(run, "crnngan", shape):
        _close_losses(res[phase][0], ref[0])
        _close_jax(res[phase][1], ref[1])
        if phase != "pre":
            assert res[phase][2] == ((True, False) if phase == TRAINED else (False, True))


@pytest.mark.parametrize("shape", [(2, 1, 1), (2, 1, 2)], ids=["data2", "data2xmodel2"])
def test_crnngan_ranks_take_the_global_gate_decision(run, shape):
    """The two data ranks' local D accuracy and mean decision on the fakes
    lie on either side of both gates of the frozen-D configuration; every
    rank takes the global decision (D frozen, G by feature matching), as
    JAX's step on the whole batch does, and finishes."""
    acc, mpf = run["local"]
    thr, fm_below = run["split"]["d_too_strong"], run["split"]["feature_matching_below"]
    assert min(acc) < thr <= np.mean(acc) < max(acc) and np.mean(mpf) < fm_below < max(mpf)
    for res in _mesh_results(run, "crnngan", shape):
        assert res[FROZEN][2] == (False, True)
        assert res[FROZEN][0][2] == pytest.approx(float(np.mean(acc)), abs=1e-6)


def test_seq_ranks_are_replicas(run):
    """On ``data=2 x seq=2`` the seq ranks hold their data rank's rows and
    draws: SeqGAN's three steps and C-RNN-GAN's feature-matching step (its
    feature means averaged over ``(data, seq)``) give JAX's update of the
    global batch, as on ``data=2``."""
    for phase in ("mle", "d", "pg"):
        ref = run["refs"]["seqgan"][phase]
        for res in _mesh_results(run, "seqgan", SEQ_MESH):
            _close_losses(res[phase][0], ref[0])
            _close_jax(res[phase][1], ref[1])
    ref = run["refs"]["crnngan"][FROZEN]
    for res in _mesh_results(run, "crnngan", SEQ_MESH):
        assert res[FROZEN][2] == (False, True)
        _close_losses(res[FROZEN][0], ref[0])
        _close_jax(res[FROZEN][1], ref[1])


def assert_mesh_matches(run, trainer, one, shapes=MESHES):
    """Every rank of ``shapes``' meshes gave the losses and states of ``one``
    (the port's ``mesh=None`` trainer on the whole batch and draws)."""
    for shape in shapes:
        for res in _mesh_results(run, trainer, shape):
            for phase, (loss, state, *_) in one.items():
                if phase != "resumed":
                    _close_losses(res[phase][0], loss)
                    _close(res[phase][1], state)


@pytest.mark.parametrize("trainer", ["seqgan", "crnngan"])
def test_mesh_matches_the_port_without_a_mesh(run, trainer):
    """The port's ``mesh=None`` trainer given the whole batch and draws gives
    every mesh's losses and states."""
    tmp, draws = run["tmp"], run["draws"][trainer]
    if trainer == "seqgan":
        one = _seqgan_steps(_seqgan_trainer(tmp / "seqgan", GB), draws, (1, 1, 1), 0)
    else:
        one = _crnngan_case(None, (1, 1, 1), tmp, draws, run["configs"])
    assert_mesh_matches(run, trainer, one)


def assert_resumed(run, trainer):
    for shape in MESHES:
        for res in _mesh_results(run, trainer, shape):
            _close_jax(res["resumed"], run["states"][trainer], rel=0)


@pytest.mark.parametrize("trainer", ["seqgan", "crnngan"])
def test_every_mesh_resumes_the_jax_checkpoint(run, trainer):
    """Restored from the checkpoint JAX's code wrote, every rank of every
    mesh holds its state exactly (D split over ``model`` and, for
    C-RNN-GAN, repacked, then gathered back)."""
    assert_resumed(run, trainer)


def test_model_split_checkpoint_restores_anywhere(run):
    """C-RNN-GAN's checkpoint saved from the ``model=2`` mesh after its GAN
    step holds the mesh's gathered state in torch's gate order: a
    ``mesh=None`` port trainer and JAX's trainer restore it leaf for leaf
    (tests/test_crnngan.py:258's contract)."""
    saved = _mesh_results(run, "crnngan", (1, 1, 2))[0][TRAINED][1]
    path = run["tmp"] / "crnngan_mesh"
    port = tcgt.CRnnGanTrainer(tcgt.CRnnGanTrainConfig(cfg=TCG, **CG_TRAIN), seed=3,
                               device="cpu")
    back = jcgt.CRnnGanTrainer(jcgt.CRnnGanTrainConfig(cfg=JCG, **CG_TRAIN), seed=3)
    assert port.restore(path) == 3 and back.restore(path) == 3
    _close_jax(saved, back.state(), rel=0)
    _close(_np_tree(port.state()), saved, rel=0)
