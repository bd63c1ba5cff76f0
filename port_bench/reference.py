"""The plain reference: PL-BERT's training step in fp32, written out.

ALBERT as PL-BERT trains it (arXiv:2301.08810; HF ``AlbertModel``): the
factorized embedding (word + position + token type 0, LayerNorm,
dropout), its mapping to the hidden width, and one shared layer applied
``num_hidden_layers`` times — self-attention with dropout on the
probabilities, dropout + residual + LayerNorm, the tanh-GELU FFN,
dropout + residual + LayerNorm — then the phoneme head and, in the
multi-task model, the grapheme head. The loss of each head is PL-BERT's:
each row's mean cross-entropy over its masked positions, averaged over
the rows that have any; micro-batches of one step are weighted by their
rows with masks, as one batch. Then AdamW (decoupled decay on all but
the pooler, bias-corrected moments, a constant rate).

Everything runs in fp32 with TF32 off, in blocks of rows so that the
[rows, heads, L, L] attention fits. The dropout masks come from
``philox.py`` and the step's draws and batches from ``feed.py``. It
imports nothing of the program.

``rounding`` swaps in another precision where the program keeps its
compute dtype: the control runs this step with every matmul operand,
activation and its gradient rounded to fp8 (e4m3, one scale a tensor).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import philox
from port_bench.feed import mask_on_device, step_draws
from port_bench.weights import layer_name

NEG = -0.7 * torch.finfo(torch.float32).max


class _FP8(torch.autograd.Function):
    """Round to fp8 e4m3 with one scale a tensor, forward and backward."""

    @staticmethod
    def _round(x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def forward(ctx, x):
        return _FP8._round(x)

    @staticmethod
    def backward(ctx, g):
        return _FP8._round(g)


ROUNDINGS = {"fp32": lambda x: x, "fp8": _FP8.apply}


def _rows_with_masks(valid) -> torch.Tensor:
    return (valid.sum(dim=1) > 0).sum()


class Reference:
    """The model's fp32 parameters and AdamW state, stepped on the
    batches of ``feed.py``. ``model``, ``train``: the configuration's
    sections; ``data``: the mix's ``dataset_params`` (masking, path)."""

    def __init__(self, model: dict, train: dict, data: dict, weights: dict,
                 rounding: str = "fp32", block_rows: int = 16) -> None:
        self.m, self.t, self.data = model, train, data
        self.params = {n: w.detach().clone().float().requires_grad_(True)
                       for n, w in weights.items()}
        self.moments = {n: (torch.zeros_like(p), torch.zeros_like(p))
                        for n, p in self.params.items()}
        self.count = 0
        self.rnd = ROUNDINGS[rounding]
        self.block_rows = block_rows

    # --- the forward of a block of rows --------------------------------------

    def _lin(self, x, name: str):
        w, b = self.params[name + ".weight"], self.params[name + ".bias"]
        return self.rnd(x) @ self.rnd(w).t() + b

    def _ln(self, x, name: str):
        return F.layer_norm(x, (x.shape[-1],), self.params[name + ".weight"],
                            self.params[name + ".bias"], self.m["layer_norm_eps"])

    def _ln_dropout(self, x, seed: int, row0: int):
        rate = self.m["dropout"]
        if rate <= 0:
            return x
        R, L, H = x.shape
        offsets = torch.arange(row0 * L * H, (row0 + R) * L * H, device=x.device).view(R, L, H)
        keep = philox.layernorm_keep(seed, rate, offsets)
        return torch.where(keep, x * (1.0 / (1.0 - rate)), 0.0)

    def _attention_keep(self, seed: int, allowed, row0: int, heads: int):
        R, L, _ = allowed.shape
        b, q, k = allowed.nonzero(as_tuple=True)
        h = torch.arange(heads, device=allowed.device)[None, :]
        stream = (b[:, None] + row0) * heads + h
        keep = torch.zeros((R, heads, L, L), dtype=torch.bool, device=allowed.device)
        keep[b[:, None], h, q[:, None], k[:, None]] = philox.attention_keep(
            seed, self.m["dropout"], stream, q[:, None], k[:, None])
        return keep

    def _attention(self, x, allowed, seed: int, row0: int):
        m = self.m
        R, L, H = x.shape
        nh = m["num_attention_heads"]
        D = H // nh
        q, k, v = (self._lin(x, layer_name(f"attention.{n}")).view(R, L, nh, D)
                   for n in ("query", "key", "value"))
        s = torch.einsum("blhd,bmhd->bhlm", self.rnd(q), self.rnd(k)) / math.sqrt(D)
        s = s.masked_fill(~allowed[:, None], NEG)
        p = torch.softmax(s, dim=-1)
        rate = m["dropout"]
        if rate > 0:
            keep = self._attention_keep(seed, allowed, row0, nh)
            p = torch.where(keep, p * (1.0 / (1.0 - rate)), 0.0)
        ctx = torch.einsum("bhlm,bmhd->blhd", self.rnd(p), self.rnd(v)).reshape(R, L, H)
        return self._lin(ctx, layer_name("attention.dense"))

    def _encode(self, rows: dict, seeds: list, emb_keep, row0: int):
        """The final hidden states [R, L, H] of a block of rows."""
        m, P = self.m, self.params
        ids = rows["masked_ids"].long()
        R, L = ids.shape
        pos = rows.get("position_ids")
        pos = torch.arange(L, device=ids.device)[None].expand(R, L) if pos is None else pos.long()
        x = (P["encoder.embeddings.word_embeddings.weight"][ids]
             + P["encoder.embeddings.position_embeddings.weight"][pos]
             + P["encoder.embeddings.token_type_embeddings.weight"][0])
        x = self._ln(x, "encoder.embeddings.LayerNorm")
        if emb_keep is not None:
            x = torch.where(emb_keep, x * (1.0 / (1.0 - m["dropout"])), 0.0)
        h = self._lin(x, "encoder.encoder.embedding_hidden_mapping_in")
        valid = torch.arange(L, device=ids.device)[None] < rows["lengths"][:, None].long()
        allowed = valid[:, :, None] & valid[:, None, :]
        seg = rows.get("segment_ids")
        if seg is not None:
            allowed &= seg[:, :, None] == seg[:, None, :]
        for i in range(m["num_hidden_layers"]):
            s_att, s_ln1, s_ln2 = seeds[1 + 3 * i: 4 + 3 * i]
            att = self._attention(h, allowed, s_att, row0)
            a = self.rnd(self._ln(self._ln_dropout(att, s_ln1, row0) + h,
                                  layer_name("attention.LayerNorm")))
            f = self._lin(F.gelu(self._lin(a, layer_name("ffn")), approximate="tanh"),
                          layer_name("ffn_output"))
            h = self.rnd(self._ln(self._ln_dropout(f, s_ln2, row0) + a,
                                  layer_name("full_layer_layer_norm")))
        return h

    @staticmethod
    def _row_means(nll, valid):
        """Σ over rows with masks of each row's mean NLL over its masked
        positions."""
        w = valid.float()
        sums, counts = (nll * w).sum(dim=1), w.sum(dim=1)
        return torch.where(counts > 0, sums / counts.clamp_min(1.0), 0.0).sum()

    def _block_losses(self, rows: dict, seeds: list, emb_keep, row0: int):
        """(Σ row means of the phoneme loss, of the grapheme loss) of a block."""
        h = self._encode(rows, seeds, emb_keep, row0)
        L = h.shape[1]
        valid = rows["mask_positions"].bool() & (
            torch.arange(L, device=h.device)[None] < rows["lengths"][:, None].long())
        logits = self._lin(h, "phoneme_predictor")
        nll = -torch.log_softmax(logits, dim=-1).gather(
            -1, rows["label_ids"].long()[..., None])[..., 0]
        loss_p = self._row_means(nll, valid)
        if "token_predictor.weight" not in self.params:
            return loss_p, torch.zeros((), device=h.device)
        b, l = valid.nonzero(as_tuple=True)
        lt = self._lin(h[b, l], "token_predictor")
        nll_t = -torch.log_softmax(lt, dim=-1).gather(
            -1, rows["token_ids"][b, l].long()[:, None])[:, 0]
        per = torch.zeros(valid.shape, device=h.device).index_put((b, l), nll_t)
        return loss_p, self._row_means(per, valid)

    # --- a step ----------------------------------------------------------------

    def _micro_inputs(self, batch: dict, mask_seed, device) -> dict:
        rows = {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}
        if mask_seed is not None:
            rows["masked_ids"], rows["mask_positions"] = mask_on_device(
                rows["label_ids"], rows["word_ids"], rows["lengths"], mask_seed, self.data)
        return rows

    def step(self, micro_batches: list, step: int, seed: int) -> float:
        """One optimizer step on ``micro_batches`` (dicts of host arrays);
        → the step's loss. ``step`` counts from 0, as the program's."""
        device = next(iter(self.params.values())).device
        ondevice = bool(self.data["ondevice_masking"])
        draws = step_draws(seed, step, len(micro_batches), self.m["num_hidden_layers"],
                           ondevice)
        inputs = [self._micro_inputs(b, s, device) for b, (s, _) in zip(micro_batches, draws)]
        n_total = sum(int(_rows_with_masks(r["mask_positions"].bool() & (
            torch.arange(r["label_ids"].shape[1], device=device)[None]
            < r["lengths"][:, None].long()))) for r in inputs)
        denom = max(n_total, 1)
        for p in self.params.values():
            p.grad = None
        loss = 0.0
        for rows, (_, seeds) in zip(inputs, draws):
            B, L = rows["label_ids"].shape
            emb_keep = None
            if self.m["dropout"] > 0:
                gen = torch.Generator(device=device).manual_seed(int(seeds[0]))
                emb_keep = torch.rand((B, L, self.m["embedding_size"]), generator=gen,
                                      device=device) >= self.m["dropout"]
            for r0 in range(0, B, self.block_rows):
                block = {k: v[r0:r0 + self.block_rows] for k, v in rows.items()}
                keep = None if emb_keep is None else emb_keep[r0:r0 + self.block_rows]
                lp, lt = self._block_losses(block, seeds, keep, r0)
                ((lp + lt) / denom).backward()
                loss += float(lp.detach() + lt.detach()) / denom
        self._adamw()
        return loss

    @torch.no_grad()
    def _adamw(self) -> None:
        t = self.t
        b1, b2 = t["adam_b1"], t["adam_b2"]
        self.count += 1
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        for name, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu, nu = self.moments[name]
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g * g)
            u = (mu / c1) / (torch.sqrt(nu / c2) + t["adam_eps"])
            if "pooler" not in name.split("."):
                u = u + t["weight_decay"] * p
            p.add_(-t["learning_rate"] * u)

    def grads(self) -> dict:
        """The last step's averaged gradients (zeros where none flowed)."""
        return {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach()
                for n, p in self.params.items()}
