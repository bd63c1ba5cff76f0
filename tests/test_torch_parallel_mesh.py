"""The port's (data, model) mesh and sharding rules
(``pl_bert_tpu_torch/parallel/mesh.py``, ``parallel/tp.py``'s seeds)
against JAX's (``pl_bert_tpu/parallel/mesh.py``, ``parallel/tp.py``), on
the 8-device CPU mesh of tests/conftest.py, with no process group: the
rank layout and JAX's errors, ``param_spec`` against ``param_shardings``
and ``zero1_partition`` against ``zero1_shardings`` dimension for
dimension (torch's layout is JAX's transposed for dense kernels) on a
small multi-task model (the vocabulary-parallel grapheme head included),
the head's row split at even and uneven V, and ``shard_seed_offset`` against
``_shard_seed_offset`` under ``shard_map`` for every shard of a 4×2 mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pl_bert_tpu_torch.export.bridge import _MODEL_MAP, _TOKEN_MAP
from pl_bert_tpu_torch.parallel import mesh as port_mesh
from pl_bert_tpu_torch.parallel import tp as port_tp


@pytest.fixture(scope="module")
def jax_params():
    from pl_bert_tpu.config import ModelParams
    from pl_bert_tpu.models.albert import build_model, init_params

    mp = ModelParams(hidden_size=64, num_attention_heads=4, intermediate_size=128,
                     max_position_embeddings=32, num_hidden_layers=2, embedding_size=16,
                     num_token_vocab=96)
    return init_params(build_model(mp, mixed_precision="fp32"), max_seq_length=32, seed=0)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _axis_dim(spec, axis: str, ndim: int):
    """The dimension of a JAX PartitionSpec that carries ``axis``, or None."""
    for i, entry in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        if entry == axis or (isinstance(entry, tuple) and axis in entry):
            return i
    return None


def _torch_dim(dim, transpose: bool, ndim: int):
    return None if dim is None else (ndim - 1 - dim if transpose else dim)


def _jax_mesh(data, model):
    from pl_bert_tpu.parallel.mesh import make_mesh

    return make_mesh(data=data, model=model, devices=jax.devices("cpu")[:data * model])


def test_layout_is_jax_reshape():
    """Rank r sits where JAX's reshape(data, model) puts device r; the
    groups are the grid's rows (model) and columns (data)."""
    jm = _jax_mesh(4, 2)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    groups = port_mesh.layout(4, 2)
    for d in range(4):
        for r in range(2):
            rank = int(ids[d, r])
            cell = port_mesh.Mesh(4, 2, rank)
            assert (cell.data_index, cell.model_index) == (d, r)
            assert rank in groups["model"][d] and rank in groups["data"][r]
    assert groups["model"] == ids.tolist() and groups["data"] == ids.T.tolist()


@pytest.mark.parametrize("data,model", [(1, 2), (2, 1), (-1, 3)])
def test_make_mesh_raises_jax_errors(data, model):
    """One process: what does not fit raises JAX's message for one device."""
    from pl_bert_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError) as want:
        make_mesh(data=data, model=model, devices=jax.devices("cpu")[:1])
    with pytest.raises(ValueError) as got:
        port_mesh.make_mesh(data, model)
    assert str(got.value) == str(want.value)
    assert port_mesh.make_mesh(-1, 1).size == 1


def test_param_spec_matches_param_shardings(jax_params):
    """Every parameter's model-axis dimension, transposed for dense
    kernels; the grapheme head's too (vocabulary-parallel: the [V, H]
    weight's rows and the bias)."""
    from pl_bert_tpu.parallel.mesh import MODEL_AXIS, param_shardings

    specs = param_shardings(_jax_mesh(4, 2), jax_params)
    for name, path, transpose in _MODEL_MAP + _TOKEN_MAP:
        ndim = np.ndim(_get(jax_params, path))
        want = _torch_dim(_axis_dim(_get(specs, path).spec, MODEL_AXIS, ndim), transpose, ndim)
        assert port_mesh.param_spec(name) == want, name
    assert port_mesh.param_spec("token_predictor.weight") == 0
    assert port_mesh.param_spec("token_predictor.bias") == 0


@pytest.mark.parametrize("data,model", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_zero1_partition_matches_zero1_shardings(jax_params, data, model):
    """The dimension of each moment a data rank owns, with the data factor
    stacked onto a tensor-parallel dimension where JAX stacks it."""
    from pl_bert_tpu.parallel.mesh import DATA_AXIS, zero1_shardings

    specs = zero1_shardings(_jax_mesh(data, model), jax_params)
    cell = port_mesh.Mesh(data, model)
    for name, path, transpose in _MODEL_MAP + _TOKEN_MAP:
        arr = _get(jax_params, path)
        want = _torch_dim(_axis_dim(_get(specs, path).spec, DATA_AXIS, arr.ndim), transpose,
                          arr.ndim)
        shape = arr.shape[::-1] if transpose else arr.shape
        assert port_mesh.zero1_partition(name, shape, cell) == want, (name, data, model)


@pytest.mark.parametrize("V,model", [(64, 2), (65, 2), (101, 2), (101, 4), (60000, 2)])
def test_head_shards_cover_the_vocabulary(V, model):
    """Each model rank's rows of the head: ⌈V/m⌉ or fewer, in rank order,
    together the whole [V, H] weight and [V] bias."""
    import torch

    w, b = torch.randn(V, 4), torch.randn(V)
    cells = [port_mesh.Mesh(1, model, r) for r in range(model)]
    parts = [port_mesh.shard("token_predictor.weight", w, c) for c in cells]
    assert all(p.shape[0] <= -(-V // model) for p in parts)
    assert torch.equal(torch.cat(parts), w)
    assert torch.equal(torch.cat([port_mesh.shard("token_predictor.bias", b, c)
                                  for c in cells]), b)
    starts = [port_mesh.split_bounds(V, model, r)[0] for r in range(model)]
    assert starts == [sum(len(p) for p in parts[:r]) for r in range(model)]


def test_shard_seed_offsets_match_jax():
    """(r + m·d)·2^20 for every shard of a 4×2 mesh, as JAX's shard_map
    evaluates it; the attention seeds distinct on all 8 shards and the LN
    seeds shared within a data row, for seeds up to the kernels' largest,
    each mapped into the kernels' range."""
    from jax.sharding import PartitionSpec as P

    from pl_bert_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS
    from pl_bert_tpu.parallel.tp import _shard_seed_offset

    grid = np.asarray(jax.shard_map(
        lambda: _shard_seed_offset(2).reshape(1, 1), mesh=_jax_mesh(4, 2), in_specs=(),
        out_specs=P(DATA_AXIS, MODEL_AXIS), check_vma=False)())
    for d in range(4):
        for r in range(2):
            assert port_tp.shard_seed_offset(d, r, 2) == int(grid[d, r])
    assert port_tp.shard_seed_offset(1023, 1, 2**20) == int(
        jnp.int32(1 + 2**20 * 1023) * jnp.int32(port_tp.SEED_STRIDE))  # wraps as int32
    for seed in (0, 12345, 2**31 - 2 - 3 * port_tp.SEED_STRIDE, 2**31 - 2):
        attn, ln = set(), {}
        for rank in range(8):
            cell = port_mesh.Mesh(4, 2, rank)
            a = port_tp.attention_seed(seed, cell)
            lns = port_tp.ln_seed(seed, cell, sp=False)
            assert 0 <= a <= 2**31 - 2 and 0 <= lns <= 2**31 - 2
            attn.add(a)
            ln.setdefault(cell.data_index, set()).add(lns)
            assert port_tp.ln_seed(seed, cell, sp=True) == a
        assert len(attn) == 8
        assert all(len(v) == 1 for v in ln.values()) and len(set().union(*ln.values())) == 4
    assert port_tp.attention_seed(77, port_mesh.Mesh()) == 77
