"""``music_tpu_torch.parallel`` against ``music_tpu.parallel``: the mesh
shape rules (``MeshSpec.resolve``) over a table of cases, the rank layout
(rank r where JAX puts device r), the data rows of ``P("data")`` and the
``(data, seq)`` blocks of ``batch_seq_sharding``, each against the shards
JAX's ``NamedSharding`` gives the 8 CPU devices, and, on a spawned group
of 4 gloo ranks, ``make_mesh``'s process groups, the halo exchange and the
collectives' gradients against the unsharded computation."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from jax.sharding import NamedSharding

from music_tpu.parallel import mesh as jmesh
from music_tpu_torch.parallel import launch
from music_tpu_torch.parallel import mesh as tmesh
from music_tpu_torch.parallel.collectives import all_gather, copy_to, pmean, reduce_from
from music_tpu_torch.parallel.halo import left_halo_exchange
from test_torch_port import one_torch_thread  # noqa: F401  (autouse)

RESOLVE_CASES = [
    ((-1, 1, 1), 8), ((2, -1, 1), 8), ((2, 2, -1), 8), ((1, 1, 1), 1), ((-1, 2, 2), 4),
    ((2, 2, 2), 8), ((3, -1, 1), 8), ((-1, -1, 1), 4), ((2, 2, 2), 4), ((-1, 3, 1), 6),
    ((4, 1, 1), 8),
]
SHAPES = [(8, 1, 1), (1, 8, 1), (1, 1, 8), (2, 2, 2), (4, 2, 1), (2, 1, 4), (1, 2, 4)]
LAYOUTS = [(4, 1, 1), (1, 4, 1), (1, 1, 4), (2, 2, 1), (1, 2, 2), (2, 1, 2)]
HALO = 3


@pytest.mark.parametrize("sizes,n", RESOLVE_CASES, ids=str)
def test_meshspec_resolve_matches_jax(sizes, n):
    """The same shape, or the same refusal."""
    def outcome(spec_cls):
        try:
            return spec_cls(*sizes).resolve(n)
        except ValueError as e:
            return ("ValueError", str(e))

    assert outcome(tmesh.MeshSpec) == outcome(jmesh.MeshSpec)


def _views(shape):
    """Every rank's :class:`Mesh` of ``shape`` (no process group needed to
    read the layout and the shardings)."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    return [tmesh.Mesh(ranks, r, torch.device("cpu"), {g: None for g in tmesh.GROUPS})
            for r in range(ranks.size)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rank_layout_matches_jax_device_layout(shape):
    """Rank r sits where JAX's ``make_mesh`` puts device r (``model``
    fastest), and ``line`` lists the ranks along an axis in order."""
    jm = jmesh.make_mesh(jmesh.MeshSpec(*shape), devices=jax.devices()[:int(np.prod(shape))])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(ids, np.array(range(ids.size)).reshape(shape))
    for view in _views(shape):
        pos = tuple(view.coords[a] for a in tmesh.AXES)
        assert ids[pos] == view.rank
        assert view.shape == dict(zip(tmesh.AXES, shape))
        for i, axis in enumerate(tmesh.AXES):
            idx = list(pos)
            idx[i] = slice(None)
            assert view.line(axis) == list(ids[tuple(idx)])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_data_rows_and_seq_blocks_match_jax_shards(shape):
    """Each rank's block of a ``[16, 8, 3]`` batch, by ``batch_sharding``
    (``shard_batch``) and ``batch_seq_sharding``, is the shard JAX places
    on device r; ranks along ``seq`` and ``model`` share their data rows."""
    x = np.arange(16 * 8 * 3, dtype=np.float32).reshape(16, 8, 3)
    jm = jmesh.make_mesh(jmesh.MeshSpec(*shape), devices=jax.devices()[:int(np.prod(shape))])
    for spec_of, jspec in ((tmesh.batch_sharding, jmesh.batch_sharding(jm, 3)),
                           (lambda m, nd: tmesh.batch_seq_sharding(m, nd),
                            jmesh.batch_seq_sharding(jm, 3))):
        shards = {s.device.id: np.asarray(s.data)
                  for s in jax.device_put(x, jspec).addressable_shards}
        assert isinstance(jspec, NamedSharding)
        for view in _views(shape):
            ours = tmesh.shard(view, x, spec_of(view, 3)).numpy()
            np.testing.assert_array_equal(ours, shards[view.rank])
    for view in _views(shape):
        np.testing.assert_array_equal(tmesh.shard_batch(view, x).numpy(),
                                      x[tmesh.block(16, shape[0], view.index("data"))])
    assert tmesh.replicated(_views(shape)[0]) == ()


def test_one_rank_mesh_needs_no_process_group():
    """JAX's "degrade to one device": no groups, every collective the
    identity, the batch whole."""
    assert not dist.is_initialized()
    m = tmesh.make_mesh(tmesh.MeshSpec(), device="cpu")
    assert m.shape == {"data": 1, "seq": 1, "model": 1} and m.is_main
    assert all(m.group(g) is None for g in tmesh.GROUPS)
    x = torch.arange(6.0, requires_grad=True)
    y = pmean(reduce_from(copy_to(x, m.group("model")), m.group("model")).sum(), m)
    assert float(y.detach()) == 15.0
    with pytest.raises(RuntimeError, match="initialised process group"):
        tmesh.make_mesh(tmesh.MeshSpec(data=2), ranks=[0, 1], device="cpu")
    with pytest.raises(ValueError, match="increase"):
        tmesh.make_mesh(tmesh.MeshSpec(), ranks=[0, 0], device="cpu")


def _halo_case(mesh, x, fill, w):
    """This rank's halo-extended chunk of ``x`` (time split over seq=4),
    and the gradients of ``sum(y * w_block)`` for the chunk and the fill."""
    T = x.shape[1] // 4
    s = mesh.index("seq")
    xl = torch.from_numpy(x[:, s * T:(s + 1) * T]).requires_grad_(True)
    fl = torch.from_numpy(fill).requires_grad_(True)
    y = left_halo_exchange(xl, HALO, mesh, first_shard_fill=fl)
    (y * torch.from_numpy(w[:, s * (T + HALO):(s + 1) * (T + HALO)])).sum().backward()
    y0 = left_halo_exchange(xl.detach(), HALO, mesh)  # no fill: shard 0 gets zeros
    return y.detach().numpy(), xl.grad.numpy(), fl.grad.numpy(), y0.numpy()


def _collectives_case(mesh, v):
    """``copy_to``/``reduce_from`` over ``model`` and ``all_gather`` over
    ``seq`` (1, 2, 2), with their gradients."""
    x = torch.from_numpy(v).requires_grad_(True)
    r = mesh.index("model")
    # a column-parallel product: each model rank's half of the columns
    part = copy_to(x, mesh.group("model")) * (r + 1)
    total = reduce_from(part, mesh.group("model"))  # the row-parallel sum
    gathered = all_gather(total * (mesh.index("seq") + 1), mesh.group("seq"), dim=0)
    loss = pmean((gathered ** 2).sum(), mesh)
    loss.backward()
    return gathered.detach().numpy(), loss.item(), x.grad.numpy()


def _rank_cases(x, fill, w, v):
    out = {}
    for shape in LAYOUTS:
        m = tmesh.make_mesh(tmesh.MeshSpec(*shape), device="cpu")
        out[("groups", shape)] = {
            axes: dist.get_process_group_ranks(m.group(axes)) for axes in tmesh.GROUPS}
        out[("coords", shape)] = m.coords
    out["halo"] = _halo_case(tmesh.make_mesh(tmesh.MeshSpec(1, 4, 1), device="cpu"), x, fill, w)
    out["collectives"] = _collectives_case(
        tmesh.make_mesh(tmesh.MeshSpec(1, 2, 2), device="cpu"), v)
    return out


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 20, 3)).astype(np.float32)
    fill = rng.normal(size=(2, HALO, 3)).astype(np.float32)
    w = rng.normal(size=(2, 4 * (5 + HALO), 3)).astype(np.float32)
    v = rng.normal(size=(3, 2)).astype(np.float32)
    return {"x": x, "fill": fill, "w": w, "v": v,
            "ranks": launch.run(_rank_cases, 4, (x, fill, w, v))}


@pytest.mark.parametrize("shape", LAYOUTS, ids=lambda s: "x".join(map(str, s)))
def test_make_mesh_groups_are_the_lines_of_the_layout(run, shape):
    """``make_mesh`` over 4 ranks: each rank's group over an axis set holds
    the ranks of its line through ``np.arange(4).reshape(shape)``."""
    ids = np.arange(4).reshape(shape)
    for rank, r in enumerate(run["ranks"]):
        pos = tuple(int(c) for c in np.argwhere(ids == rank)[0])
        assert tuple(r[("coords", shape)].values()) == pos
        for axes, members in r[("groups", shape)].items():
            idx = tuple(slice(None) if a in axes else p for a, p in zip(tmesh.AXES, pos))
            assert members == sorted(ids[idx].reshape(-1).tolist()), axes


def test_halo_exchange_identity_and_gradient_at_seq_4(run):
    """Each of 4 chunks, extended by its left neighbour's last 3 steps
    (shard 0 by the fill, or zeros), equals the slice of the unsharded
    concatenation; the gradients of the chunks and the fill equal
    autograd's through that concatenation."""
    x = torch.from_numpy(run["x"]).requires_grad_(True)
    fill = torch.from_numpy(run["fill"]).requires_grad_(True)
    T = x.shape[1] // 4
    full = torch.cat([fill, x], dim=1)
    pieces = [full[:, s * T:s * T + T + HALO] for s in range(4)]
    (torch.cat(pieces, dim=1) * torch.from_numpy(run["w"])).sum().backward()
    gx = np.concatenate([r["halo"][1] for r in run["ranks"]], axis=1)
    for s, r in enumerate(run["ranks"]):
        y, _, g_fill, y0 = r["halo"]
        np.testing.assert_array_equal(y, pieces[s].detach().numpy())
        want0 = pieces[s].detach().numpy().copy()
        if s == 0:
            want0[:, :HALO] = 0
        np.testing.assert_array_equal(y0, want0)
        np.testing.assert_allclose(g_fill, fill.grad.numpy() if s == 0 else 0, atol=1e-6)
    np.testing.assert_allclose(gx, x.grad.numpy(), rtol=1e-6, atol=1e-6)


def test_collective_gradients_are_jax_transposes(run):
    """f / g / all_gather / pmean on a (1, 2, 2) mesh against the unsharded
    function ``sum_s ((1 + 2) * x * (s + 1))^2``: the same values on every
    rank, and the ranks' gradient shares, summed over ``seq`` (the
    ``(data, seq)`` group) at each model rank, its gradient."""
    x = torch.from_numpy(run["v"]).requires_grad_(True)
    total = x * 3  # (r + 1) summed over model ranks r = 0, 1
    gathered = torch.cat([total * 1, total * 2], dim=0)
    loss = (gathered ** 2).sum()
    loss.backward()
    for r in run["ranks"]:
        g, value, _ = r["collectives"]
        np.testing.assert_allclose(g, gathered.detach().numpy(), rtol=1e-6)
        assert value == pytest.approx(loss.item(), rel=1e-6)
    shares = [r["collectives"][2] for r in run["ranks"]]  # rank = 2 * seq + model
    for m in (0, 1):
        np.testing.assert_allclose(shares[m] + shares[2 + m], x.grad.numpy(), rtol=1e-5)
