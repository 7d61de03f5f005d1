"""The port's LeakGAN trainer on ``(data, seq, model)`` meshes of gloo ranks
on the CPU, held against the JAX package's unsharded steps on the global
batch with the same draws (tests/test_torch_gan_mesh.py's helpers and
tolerances):

- pretraining, D and adversarial steps on ``data=2``, ``model=2`` and
  ``data=2 x model=2``: each rank's losses and the gathered parameters and
  Adam states after each step against JAX's loss and ``jax.grad`` update
  of the global batch (JAX's model functions and the optax chains its
  trainer builds), each rank fed its rows of JAX's Gumbel noise and
  dropout masks; the rewards ranked over the global batch;
- the port's own ``mesh=None`` trainer given the whole batch and draws, on
  ``model=2`` (on a data mesh one ``goal_init`` row serves a row of every
  data rank, so no single-device trainer holds its state);
- checkpoints: every mesh trainer resumes a checkpoint written by JAX's
  checkpoint code and holds its state exactly; one saved from the
  ``model=2`` mesh restores into a ``mesh=None`` trainer and, through
  JAX's checkpoint code, into JAX's ``state()`` structure.

LeakGAN takes ``batch_size`` rows a data rank (JAX's global batch is
``batch_size`` times the data size), and its ``goal_init`` has one row per
local batch row: the JAX reference ties the data ranks' rows (the
parameter tiled inside the loss, its gradient summed)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from music_tpu.core import checkpoint as jck
from music_tpu.models import leakgan as jlg
from music_tpu_torch.models import leakgan as tlg
from music_tpu_torch.train import leakgan_train as tlgt
from test_torch_gan_mesh import (
    CLIP, GB, MESH_IDS, MESHES, _close, _close_jax, _close_losses, _jax_tx, _mesh_results,
    _np_tree, _on, _plain, _rows, _streams, _to_jax, _tokens, assert_mesh_matches,
    assert_resumed, run_beside,
)
from test_torch_seqgan import gumbel, keep_mask
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

LG_KW = dict(vocab_size=40, seq_len=10, step_size=5, goal_size=4, worker_emb_dim=8,
             worker_hidden=8, manager_hidden=8, dis_emb_dim=8, filter_sizes=(1, 2, 3),
             num_filters=(8, 8, 16), dropout=0.2)
LG_TRAIN = dict(rollout_num=2, generated_num=8, decay_step_size=2, adv_lr_scale=0.5,
                reward_delta=12.0, grad_clip=CLIP)
LB = 2  # LeakGAN's batch_size: goal_init [2, G] on every mesh
JLG, TLG = jlg.LeakGanConfig(**LG_KW), tlg.LeakGanConfig(**LG_KW)
LV, LT, LF, LN = 40, 10, 32, 2  # vocab, seq_len, features, n_goals
_LTC = tlgt.LeakGanTrainConfig(cfg=TLG, batch_size=LB, **LG_TRAIN)
_SCHED = dict(step=_LTC.decay_step_size, rate=_LTC.decay_rate)
LG_TX = {"m": _jax_tx(_LTC.m_lr, **_SCHED), "w": _jax_tx(_LTC.w_lr, **_SCHED),
         "d": _jax_tx(_LTC.d_lr, **_SCHED),
         "m_adv": _jax_tx(_LTC.m_lr * _LTC.adv_lr_scale, **_SCHED),
         "w_adv": _jax_tx(_LTC.w_lr * _LTC.adv_lr_scale, **_SCHED)}


def _lg_masks(dkey, n, rows):
    return np.stack([keep_mask(k, JLG.dropout, (rows, LF)).numpy()
                     for k in jax.random.split(dkey, n)])


def _leakgan_setup(tmp):
    """A state (``batch_size`` 2) one pretraining and one D step in, written
    by JAX's checkpoint code in JAX's ``state()`` structure; the draws of
    each step for a global batch of 4 (the data meshes) and 2 (``model=2``)."""
    tt = tlgt.LeakGanTrainer(_LTC, seed=0, device="cpu")
    tt.pre_step(torch.from_numpy(_tokens(21, LV, (LB, LT))),
                generator=torch.Generator().manual_seed(21))
    tt.d_step(torch.from_numpy(_tokens(22, LV, (LB, LT))), torch.tensor([1, 0]),
              dropout_generator=torch.Generator().manual_seed(22))
    g, d = tlg.params_to_numpy(tt.g_params), tlg.params_to_numpy(tt.d_params)
    example = {"g_params": g, "d_params": d, "m_opt": LG_TX["m"].init(g["manager"]),
               "w_opt": LG_TX["w"].init(g["worker"]), "d_opt": LG_TX["d"].init(d)}
    state = _to_jax(tt.state(), example)
    jck.save(tmp / "leakgan", 2, state)
    draws = {}
    for rows in (GB, LB):
        key, dkey, akey, adkey = jax.random.split(jax.random.PRNGKey(30 + rows), 4)
        k1, k2 = jax.random.split(akey)
        draws[rows] = {
            "pre": _tokens(23, LV, (rows, LT)), "pre_keys": (key, dkey),
            "pre_noise": gumbel(key, LT + 1, (rows, LV)).numpy(),
            "pre_masks": _lg_masks(dkey, LT + 1, rows), "adv_keys": (akey, adkey),
            "adv_noise": gumbel(k1, LT + 1, (rows, LV)).numpy(),
            "rollout_noise": gumbel(k2, LT, (2 * LN * rows, LV)).numpy(),
            "adv_masks": _lg_masks(adkey, LT + 1, rows),
        }
    dkey = jax.random.PRNGKey(40)
    draws["d"] = {"tokens": _tokens(24, LV + 1, (GB, LT)),
                  "labels": np.array([0, 1, 1, 0], np.int32), "key": dkey,
                  "mask": keep_mask(dkey, JLG.dropout, (GB, LF)).numpy()}
    return state, draws


def _tiled(g, dp):
    """G with ``goal_init`` repeated for ``dp`` data ranks: the global batch
    of ``dp`` ranks of ``batch_size`` rows each."""
    return {"manager": {**g["manager"], "goal_init": jnp.tile(g["manager"]["goal_init"],
                                                              (dp, 1))},
            "worker": g["worker"]}


@functools.partial(jax.jit, static_argnums=0)
def _jlg_pre(dp, g, d, m_opt, w_opt, real, key, dkey):
    """JAX's ``pre_step`` on one device, ``goal_init`` tied across ``dp``
    data ranks."""
    def m_loss(m):
        rets = jlg.pre_engine(_tiled({"manager": m, "worker": g["worker"]}, dp), d, real, key,
                              cfg=JLG, dropout_key=dkey)
        return jlg.pre_manager_loss(rets["real_goal"], rets["delta_feature"])

    def w_loss(w):
        rets = jlg.pre_engine(_tiled({"manager": g["manager"], "worker": w}, dp), d, real, key,
                              cfg=JLG, dropout_key=dkey)
        return jlg.pre_worker_loss(real, rets["prediction"], JLG.vocab_size)

    ml, mg = jax.value_and_grad(m_loss)(g["manager"])
    wl, wg = jax.value_and_grad(w_loss)(g["worker"])
    mu, m_opt = LG_TX["m"].update(mg, m_opt)
    wu, w_opt = LG_TX["w"].update(wg, w_opt)
    return ({"manager": optax.apply_updates(g["manager"], mu),
             "worker": optax.apply_updates(g["worker"], wu)}, m_opt, w_opt, ml, wl)


@functools.partial(jax.jit, static_argnums=0)
def _jlg_adv(dp, g, d, m_opt, w_opt, key, dkey):
    """JAX's ``adv_step_impl`` on one device (the rewards ranked over the
    whole batch), ``goal_init`` tied across ``dp`` data ranks."""
    k1, k2 = jax.random.split(key)

    def losses(gp):
        gt = _tiled(gp, dp)
        rets = jlg.adv_engine(gt, d, k1, LB * dp, cfg=JLG, temperature=JLG.temperature,
                              dropout_key=dkey)
        rewards = jlg.get_rewards(gt, d, rets["gen_token"], k2, cfg=JLG,
                                  rollout_num=_LTC.rollout_num, temperature=JLG.temperature,
                                  delta=_LTC.reward_delta)
        ml = jlg.adv_manager_loss(rewards, rets["real_goal"], rets["delta_feature"])
        wl = jlg.adv_worker_loss(rets["all_goal"], rets["delta_feature_for_worker"],
                                 rets["gen_token"], rets["prediction"], JLG.vocab_size)
        return ml + wl, (ml, wl)

    (_, (ml, wl)), grads = jax.value_and_grad(losses, has_aux=True)(g)
    mu, m_opt = LG_TX["m_adv"].update(grads["manager"], m_opt)
    wu, w_opt = LG_TX["w_adv"].update(grads["worker"], w_opt)
    return ({"manager": optax.apply_updates(g["manager"], mu),
             "worker": optax.apply_updates(g["worker"], wu)}, m_opt, w_opt, ml, wl)


@jax.jit
def _jlg_d(d, opt, tokens, labels, dkey):
    loss, grads = jax.value_and_grad(jlg.dis_loss)(d, tokens, labels, JLG, dkey)
    up, opt = LG_TX["d"].update(grads, opt)
    return optax.apply_updates(d, up), opt, loss


def _leakgan_reference(state, draws):
    """JAX's pretraining, D and adversarial steps in sequence, for each
    global batch."""
    out = {}
    for rows in (GB, LB):
        dr, dp = draws[rows], rows // LB
        g, m_opt, w_opt, ml, wl = _jlg_pre(dp, state["g_params"], state["d_params"],
                                           state["m_opt"], state["w_opt"], dr["pre"],
                                           *dr["pre_keys"])
        after = {**state, "g_params": g, "m_opt": m_opt, "w_opt": w_opt}
        out[("pre", rows)] = ((float(ml), float(wl)), after)
        dd = draws["d"]
        d, d_opt, loss = _jlg_d(state["d_params"], state["d_opt"], dd["tokens"], dd["labels"],
                                dd["key"])
        after = {**after, "d_params": d, "d_opt": d_opt}
        out[("d", rows)] = (float(loss), after)
        g, m_opt, w_opt, ml, wl = _jlg_adv(dp, g, d, m_opt, w_opt, *dr["adv_keys"])
        out[("adv", rows)] = ((float(ml), float(wl)),
                              {**after, "g_params": g, "m_opt": m_opt, "w_opt": w_opt})
    return out


def _leakgan_steps(tt, draws, shape, index):
    """Pretraining, D and adversarial steps on this rank's rows: the losses
    and the state after each."""
    rows = LB * shape[0]
    dr, dd, t = draws[rows], draws["d"], torch.from_numpy
    mine, drows = _rows(shape, index, rows), _rows(shape, index, GB)
    out = {"resumed": _np_tree(tt.state())}
    ml, wl = tt.pre_step(t(dr["pre"][mine]), noise=t(dr["pre_noise"][:, mine]),
                         dropout_mask=t(dr["pre_masks"][:, mine]))
    out["pre"] = ((float(ml), float(wl)), _np_tree(tt.state()))
    loss = tt.d_step(t(dd["tokens"][drows]), t(dd["labels"][drows]),
                     dropout_mask=t(dd["mask"][drows]))
    out["d"] = (float(loss), _np_tree(tt.state()))
    ml, wl = tt.adv_step(adv_noise=t(dr["adv_noise"][:, mine]),
                         rollout_noise=t(_streams(dr["rollout_noise"], index, shape, (2, LN))),
                         dropout_mask=t(dr["adv_masks"][:, mine]))
    out["adv"] = ((float(ml), float(wl)), _np_tree(tt.state()))
    return out


def _leakgan_trainer(path, mesh=None):
    tt = tlgt.LeakGanTrainer(_LTC, seed=0, mesh=mesh, device="cpu")
    assert tt.restore(path) == 2
    return tt


def _leakgan_case(mesh, shape, tmp, draws):
    tt = _leakgan_trainer(tmp / "leakgan", mesh)
    out = _leakgan_steps(tt, draws, shape, mesh.index("data"))
    if shape == (1, 1, 2):
        tt.save(tmp / "leakgan_mesh", 3)
    return out


def _rank_cases(tmp, draws):
    """Every case on this rank; a rank outside a case's mesh gets None."""
    out = {}
    for shape in MESHES:
        mesh = _on(shape)
        out[("leakgan", shape)] = mesh and _leakgan_case(mesh, shape, tmp, draws)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The state written, the ranks started on it, and JAX's unsharded
    references computed meanwhile."""
    tmp = tmp_path_factory.mktemp("gan_mesh_leakgan")
    state, draws = _leakgan_setup(tmp)
    ranks, refs = run_beside(_rank_cases, (tmp, _plain(draws)),
                             lambda: {"leakgan": _leakgan_reference(state, draws)})
    return {"tmp": tmp, "ranks": ranks, "refs": refs, "states": {"leakgan": state},
            "draws": {"leakgan": draws}}


@pytest.mark.parametrize("phase", ["pre", "d", "adv"])
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_leakgan_steps_match_jax_unsharded(run, shape, phase):
    """Each rank's losses and the gathered state after the pretraining, D
    and adversarial steps (in that order) against JAX's steps on the global
    batch, ``goal_init`` tied across the data ranks and the rewards ranked
    over the global batch."""
    ref = run["refs"]["leakgan"][(phase, LB * shape[0])]
    for res in _mesh_results(run, "leakgan", shape):
        _close_losses(res[phase][0], ref[0])
        _close_jax(res[phase][1], ref[1])


def test_mesh_matches_the_port_without_a_mesh(run):
    """The port's ``mesh=None`` trainer given the whole batch and draws gives
    the ``model=2`` mesh's losses and states."""
    one = _leakgan_steps(_leakgan_trainer(run["tmp"] / "leakgan"), run["draws"]["leakgan"],
                         (1, 1, 1), 0)
    assert_mesh_matches(run, "leakgan", one, [(1, 1, 2)])


def test_every_mesh_resumes_the_jax_checkpoint(run):
    """Restored from the checkpoint JAX's code wrote, every rank of every
    mesh holds its state exactly (D split over ``model``, then gathered)."""
    assert_resumed(run, "leakgan")


def test_model_split_checkpoint_restores_anywhere(run):
    """A checkpoint saved from the ``model=2`` mesh after its steps holds the
    mesh's gathered state: a ``mesh=None`` port trainer restores it leaf
    for leaf, and so does JAX's checkpoint code into the JAX trainer's
    ``state()`` structure."""
    saved = _mesh_results(run, "leakgan", (1, 1, 2))[0]["adv"][1]
    path = run["tmp"] / "leakgan_mesh"
    port = tlgt.LeakGanTrainer(_LTC, seed=3, device="cpu")
    assert port.restore(path) == 3
    _close_jax(saved, jck.restore(path, jax.tree.map(np.zeros_like, run["states"]["leakgan"])),
               rel=0)
    _close(_np_tree(port.state()), saved, rel=0)
