"""The (data, model) process mesh and the parameter sharding rules.

The counterpart of ``pl_bert_tpu/parallel/mesh.py``. There a
``Mesh(('data', 'model'))`` of devices and GSPMD place every array; here
each process of an initialised ``torch.distributed`` world is one cell
of the mesh and holds its own shard:

- rank r sits at (data r // model, model r % model), JAX's
  ``reshape(data, model)`` (:56-63): the model axis is innermost, so
  model-parallel neighbours are adjacent ranks, on one node;
- one process group per data row (the ``model`` group: the ranks that
  split one batch slice's heads) and one per model column (the ``data``
  group: the ranks that hold the same shard of different batch slices);
- :func:`param_spec` is JAX's ``_RULES`` (:86-104) in ``nn.Linear``'s
  [out, in] layout: the dimension of a parameter the model axis splits;
- :func:`zero1_partition` is ``zero1_shardings`` (:123-167): the
  dimension of each AdamW moment a data rank owns;
- :func:`local_rows` is ``put_global``'s contract (:170-185): every
  rank builds the same global batch and keeps its data slice.

With no process group initialised, :func:`make_mesh` is the 1×1 mesh and
nothing here communicates. The grapheme head is split over the
vocabulary (JAX :97-103): a model rank holds rows [r·⌈V/m⌉, (r+1)·⌈V/m⌉)
of ``token_predictor`` (clipped at V), so a V the model axis does not
divide gives the last ranks fewer rows (:func:`split_bounds`), as
GSPMD's uneven shards do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True, eq=False)
class Mesh:
    """This process's cell of a (data, model) mesh and its two groups
    (None where the axis has one rank)."""

    data: int = 1
    model: int = 1
    rank: int = 0
    data_group: object = None
    model_group: object = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_shape(data: int = -1, model: int = 1) -> tuple[int, int]:
    """(data, model) over the initialised world; ``data=-1`` takes the
    ranks the model axis leaves. Raises ``ValueError`` with JAX's messages
    when the axes do not divide the world."""
    n = world_size()
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide {n} devices")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return data, model


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """The (data, model) mesh over the initialised world (the 1×1 mesh
    without one), as :func:`mesh_shape` sizes it. Every rank must call
    it: it creates the groups."""
    data, model = mesh_shape(data, model)
    if data * model == 1:
        return Mesh()
    rank = dist.get_rank()
    groups = {}
    # every rank creates every group, in the same order (torch's rule)
    for axis, lines in layout(data, model).items():
        for line in lines:
            group = dist.new_group(line) if len(line) > 1 else None
            if rank in line:
                groups[axis] = group
    return Mesh(data, model, rank, groups[DATA_AXIS], groups[MODEL_AXIS])


def layout(data: int, model: int) -> dict:
    """The ranks of each group: ``{"model": one list a data row, "data":
    one list a model column}`` of JAX's ``reshape(data, model)`` grid."""
    grid = np.arange(data * model).reshape(data, model)
    return {MODEL_AXIS: grid.tolist(), DATA_AXIS: grid.T.tolist()}


# (name-suffix match, the dimension the model axis splits) — first hit
# wins; JAX's kernels are [in, out], nn.Linear's weights [out, in]: the
# column-parallel query/key/value/ffn split their output (torch dim 0),
# the row-parallel dense/ffn_output their input (torch dim 1)
_RULES: list[tuple[tuple[str, ...], int]] = [
    (("attention", "query", "weight"), 0),
    (("attention", "key", "weight"), 0),
    (("attention", "value", "weight"), 0),
    (("attention", "query", "bias"), 0),
    (("attention", "key", "bias"), 0),
    (("attention", "value", "bias"), 0),
    (("attention", "dense", "weight"), 1),
    (("ffn", "weight"), 0),
    (("ffn", "bias"), 0),
    (("ffn_output", "weight"), 1),
    # the vocab-parallel grapheme head: JAX's kernel P(None, model) is
    # the [V, H] weight's rows, its bias P(model)
    (("token_predictor", "weight"), 0),
    (("token_predictor", "bias"), 0),
]


def param_spec(name: str) -> int | None:
    """The dimension of parameter ``name`` (a state-dict key) that the
    model axis splits, or None where it is replicated."""
    path = tuple(name.split("."))
    for suffix, dim in _RULES:
        if path[-len(suffix):] == suffix:
            return dim
    return None


def _jax_layout(name: str, ndim: int) -> bool:
    """Whether ``name`` is a dense weight, which JAX stores transposed
    (embedding tables carry over as they are)."""
    return ndim == 2 and not name.endswith("_embeddings.weight")


def zero1_partition(name: str, shape, mesh: Mesh) -> int | None:
    """The dimension of the moments of parameter ``name`` (global
    ``shape``, torch layout) along which data rank d owns the d-th of
    ``mesh.data`` chunks of its (tensor-parallel) shard, or None
    (replicated). JAX's choice (:138-165), reckoned in JAX's layout and
    mapped back: the first dimension whose global size divides by the data
    factor times the model factor already on it."""
    if mesh.data == 1 or len(shape) == 0:
        return None
    flip = _jax_layout(name, len(shape))
    tp_dim = param_spec(name) if mesh.model > 1 else None
    order = list(range(len(shape)))[::-1] if flip else list(range(len(shape)))
    for dim in order:  # JAX's dimension i is torch's order[i]
        factor = mesh.data * (mesh.model if dim == tp_dim else 1)
        if shape[dim] % factor == 0:
            return dim
    return None


def local_rows(array, mesh: Mesh, axis: int = 0):
    """This rank's data slice of a global batch array along ``axis``
    (numpy or torch): rows [d·B/data, (d+1)·B/data)."""
    if mesh.data == 1:
        return array
    n = array.shape[axis]
    if n % mesh.data:
        raise ValueError(f"batch {n} is not divisible by the data axis {mesh.data}")
    per = n // mesh.data
    index = [slice(None)] * array.ndim
    index[axis] = slice(mesh.data_index * per, (mesh.data_index + 1) * per)
    return array[tuple(index)]


def split_bounds(size: int, parts: int, index: int) -> tuple[int, int]:
    """[start, stop) of part ``index`` of ``size`` rows split ``parts``
    ways: ⌈size/parts⌉ rows a part, the last parts clipped (``chunk``'s
    split where it gives ``parts`` pieces)."""
    per = -(-size // parts)
    start = min(index * per, size)
    return start, min(start + per, size)


def shard(name: str, tensor: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This model rank's slice of a full parameter (or moment) ``tensor``."""
    dim = param_spec(name)
    if mesh.model == 1 or dim is None:
        return tensor
    start, stop = split_bounds(tensor.shape[dim], mesh.model, mesh.model_index)
    return tensor.narrow(dim, start, stop - start)


def zero1_shard(name: str, tensor: torch.Tensor, full_shape, mesh: Mesh) -> torch.Tensor:
    """This data rank's ZeRO-1 slice of a (tensor-parallel) moment shard."""
    dim = zero1_partition(name, full_shape, mesh)
    if dim is None:
        return tensor
    return tensor.chunk(mesh.data, dim)[mesh.data_index]


@torch.no_grad()
def shard_model(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Replace every parameter the model axis splits by this rank's
    slice of it, in place (the model holds full parameters on entry, as
    every rank built the same ones)."""
    if mesh.model == 1:
        return model
    for name, p in model.named_parameters():
        if param_spec(name) is not None:
            p.data = shard(name, p.data, mesh).contiguous().clone()
    return model
