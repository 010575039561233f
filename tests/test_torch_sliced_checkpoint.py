"""Sliced checkpoints of the port (``io/checkpoint.py`` with the mesh's
placements) against the JAX package's ``tests/test_checkpoint.py``
claims, both ways between the two packages' files: a sliced save merges
back whole (``merge_sliced``, ``restore_checkpoint`` of every rank's
file), and restores onto another mesh's blocks (``shardings=``).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mindrec_tpu.io import checkpoint as jckpt
from mindrec_tpu.models import wide_deep as jwd
from mindrec_tpu.parallel.mesh import shard_train_state as jshard
from mindrec_tpu.train import optim as jopt
from mindrec_tpu.train import step as jstep
from mindrec_tpu_torch.io import checkpoint
from mindrec_tpu_torch.models import wide_deep
from mindrec_tpu_torch.parallel import mesh as pm
from test_torch_mesh import flat, jax_mesh, state_from_jax

CFG = dict(batch_size=32, field_size=8, vocab_size=3000, emb_dim=8,
           deep_layer_dim=(16,), sparse=True,
           deep_table_slice_mode="table_row_slice")


def _states(mode="table_row_slice"):
    """(jax model, jax state, port model class+config, port state)."""
    cfg = {**CFG, "deep_table_slice_mode": mode}
    jm = jwd.WideDeepModel(jwd.WideDeepConfig(**cfg))
    js = jstep.init_train_state(jm, jax.random.PRNGKey(0), jopt.ftrl(),
                                jopt.lazy_adam())
    return jm, js, wide_deep.WideDeepConfig(**cfg), state_from_jax(js)


def _save_sliced(tmp_path, cfg, full, data, model, step=1):
    """Each rank of a (data, model) mesh saves its sliced file."""
    paths = []
    for r in range(data * model):
        mesh = pm.Mesh(data, model, rank=r)
        m = wide_deep.WideDeepModel(cfg, mesh=mesh)
        st = pm.shard_train_state(full, m, mesh)
        paths.append(checkpoint.save_checkpoint(
            tmp_path, st, step=step, process_index=r, force_sliced=True,
            shardings=pm.state_placements(full, m, mesh)))
    return paths


@pytest.mark.parametrize("mode", ["table_row_slice", "table_column_slice"])
def test_sliced_save_and_merge(tmp_path, mode):
    """4 ranks save sliced: each file holds its block of the deep table
    and of m/v under the reference's ``@@shard(...)`` names; merging all
    files gives the whole state bit for bit, in either package."""
    jm, js, cfg, full = _states(mode)
    paths = _save_sliced(tmp_path, cfg, full, 2, 2)
    assert [p.rsplit("-", 1)[1] for p in paths] == [f"r{r}.npz" for r in range(4)]
    with np.load(paths[3]) as z:
        index = json.loads(str(z["__index__"]))
        assert index[".params/deep/table"]["sliced"] is True
        assert index[".params/deep/table"]["global_shape"] == list(
            full.params["deep"]["table"].shape)
        assert index[".params/wide/table"]["sliced"] is False
        names = [n for n in z.files if n.startswith(".opt_d/deep/table/m@@shard")]
        assert len(names) == 1
    want = flat(full)
    for got in (checkpoint.merge_sliced(paths, full),
                checkpoint.restore_checkpoint(paths, full)):
        for k, v in flat(got).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    ref = jckpt.merge_sliced(paths, js)  # the reference reads the port's files
    for (k, v), (_, w) in zip(
            jax.tree_util.tree_flatten_with_path(ref)[0],
            jax.tree_util.tree_flatten_with_path(js)[0]):
        if "rng" not in jax.tree_util.keystr(k):
            np.testing.assert_array_equal(np.asarray(v), np.asarray(w))


def test_reference_sliced_file_restores_onto_port_meshes(tmp_path):
    """The reference saves sliced on its (2, 2) mesh; the port restores
    the file whole, and onto each rank's blocks of a (2, 2) and a (1, 4)
    mesh."""
    jm, js, cfg, full = _states()
    mesh = jax_mesh()
    with mesh:
        sharded = jshard(js, jwd.WideDeepModel(jwd.WideDeepConfig(
            **{**CFG}), mesh=mesh), mesh)
    path = jckpt.save_checkpoint(tmp_path, sharded, step=3, force_sliced=True)
    want = flat(full)
    got = flat(checkpoint.restore_checkpoint(path, full))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for data, model in ((2, 2), (1, 4)):
        for r in range(data * model):
            pmesh = pm.Mesh(data, model, rank=r)
            m = wide_deep.WideDeepModel(cfg, mesh=pmesh)
            like = pm.shard_train_state(full, m, pmesh)
            pls = pm.state_placements(full, m, pmesh)
            st = checkpoint.restore_checkpoint(path, like, shardings=pls)
            blk = pls.params["deep"]["table"].index
            assert torch.equal(st.params["deep"]["table"],
                               full.params["deep"]["table"][blk])
            assert torch.equal(st.opt_d["deep/table"]["v"],
                               full.opt_d["deep/table"]["v"][blk])
            assert torch.equal(st.params["wide"]["table"],
                               full.params["wide"]["table"])


def test_reshard_on_restore(tmp_path):
    """Saved sliced by 4 ranks of (2, 2), resumed onto (1, 4): every
    block restores as the whole state's slice and the forward is the
    same."""
    _jm, _js, cfg, full = _states()
    paths = _save_sliced(tmp_path, cfg, full, 2, 2)
    ids = torch.tensor([[0, 5, 2999, 17, 1, 2, 3, 4]], dtype=torch.int32)
    wts = torch.ones((1, 8))
    one = wide_deep.WideDeepModel(cfg)
    want = one.apply(full.params, ids, wts)
    for r in range(4):
        mesh = pm.Mesh(1, 4, rank=r)
        m = wide_deep.WideDeepModel(cfg, mesh=mesh)
        pls = pm.state_placements(full, m, mesh)
        st = checkpoint.restore_checkpoint(
            paths, pm.shard_train_state(full, m, mesh), shardings=pls)
        blk = pls.params["deep"]["table"].index
        assert st.params["deep"]["table"].shape[1] * 4 == \
            full.params["deep"]["table"].shape[1]
        assert torch.equal(st.params["deep"]["table"],
                           full.params["deep"]["table"][blk])
    # the whole forward on one rank of the merged state
    merged = checkpoint.merge_sliced(paths, full)
    torch.testing.assert_close(one.apply(merged.params, ids, wts), want,
                               rtol=0, atol=0)


def test_force_sliced_without_placements_saves_whole(tmp_path):
    """One process without a mesh: ``force_sliced`` saves every leaf
    whole, as the reference does for arrays on one device."""
    _jm, _js, _cfg, full = _states()
    a = checkpoint.save_checkpoint(tmp_path / "a", full, step=0, force_sliced=True)
    b = checkpoint.save_checkpoint(tmp_path / "b", full, step=0)
    with np.load(a) as za, np.load(b) as zb:
        assert za.files == zb.files
        for k in za.files:
            assert za[k].tobytes() == zb[k].tobytes(), k
    ref = jckpt.restore_checkpoint(a, jax.tree.map(jnp.asarray, _js))
    np.testing.assert_array_equal(np.asarray(ref.params["deep"]["table"]),
                                  full.params["deep"]["table"].numpy())
