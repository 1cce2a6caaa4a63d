"""Speculative decoding: acceptance math and draft-model constructors
(PyTorch port of the reference ``serving/speculative.py``).

The engine drafts ``k`` tokens per slot with a small draft model, then
scores the whole window in one target forward (``LM.verify_step``).
This module holds the acceptance math it applies to the two models'
logits, vectorised over slots so ragged batches stay in lockstep on the
device:

- ``greedy_verify``: temperature-0 acceptance.  A draft token is
  accepted iff it equals the target argmax; the emitted tokens are the
  target argmaxes themselves, so greedy speculative output is
  token-identical to plain greedy decode for any draft.
- ``speculative_sample``: the Leviathan/Chen rejection sampler.  Draft
  token ``d_i`` is accepted with probability ``min(1, p(d_i)/q(d_i))``;
  the first rejected position resamples from ``max(p - q, 0)``
  (normalised) and a fully accepted window samples a bonus token from
  the target's last-position distribution.  The emitted tokens are
  marginally distributed per the target.  Randomness comes from an
  explicit ``torch.Generator`` (the reference takes a JAX key; the two
  give different draws from the same seed).
- ``truncate_draft``: a LayerSkip-style self-speculative draft, the
  target's first ``n_layers`` blocks with shared embedding, norm and
  head.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.param import tree_leaves, tree_map


def greedy_verify(target_logits, draft_tokens):
    """Temperature-0 acceptance.

    ``target_logits``: (B, k+1, V), the target's scores for the window
    ``[tok, d_1..d_k]``; ``draft_tokens``: (B, k).  Returns
    ``(accepted, out_tokens)``: ``accepted`` (B,) in ``[0, k]`` is the
    matched-prefix length and ``out_tokens`` (B, k+1) holds the target
    argmaxes -- positions ``[0, accepted]`` are the tokens to emit (the
    accepted drafts and the bonus token after them)."""
    tgt = torch.argmax(target_logits, dim=-1)
    match = (tgt[:, :-1] == draft_tokens).to(torch.int32)
    accepted = torch.cumprod(match, dim=1).sum(dim=1)
    return accepted, tgt


def sample_categorical(gen, logits):
    """One draw per row from ``softmax(logits)`` over the last axis, by
    the Gumbel-max trick (what ``jax.random.categorical`` does), with no
    host round trip."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.argmax(logits.float() + g, dim=-1)


def speculative_sample(gen, target_logits, draft_logits, draft_tokens,
                       temperature: float = 1.0):
    """Rejection-sample a draft window against the target distribution.

    ``gen``: the ``torch.Generator`` on the logits' device;
    ``target_logits``: (B, k+1, V); ``draft_logits``: (B, k, V);
    ``draft_tokens``: (B, k) sampled from the draft distribution.
    Returns ``(accepted, out_tokens)`` with the contract of
    ``greedy_verify``: emit ``out_tokens[:, :accepted+1]``, the
    accepted draft tokens followed by one resampled (or bonus) token."""
    b, k1, _ = target_logits.shape
    k = k1 - 1
    t = max(float(temperature), 1e-6)
    p = torch.softmax(target_logits.float() / t, dim=-1)
    q = torch.softmax(draft_logits.float() / t, dim=-1)
    d = draft_tokens.long()[..., None]
    p_d = torch.gather(p[:, :k], -1, d)[..., 0]                 # (B, k)
    q_d = torch.gather(q, -1, d)[..., 0]
    u = torch.rand((b, k), generator=gen, device=p.device)
    accept = u < p_d / q_d.clamp_min(1e-20)
    accepted = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    # residual distribution at the first rejected position; a fully
    # accepted window appends a zero draft row, so the residual is the
    # target's bonus distribution p[k] unchanged
    q_pad = torch.cat([q, torch.zeros_like(p[:, :1])], dim=1)
    idx = accepted.long()[:, None, None].expand(b, 1, p.shape[-1])
    p_at = torch.gather(p, 1, idx)[:, 0]                        # (B, V)
    q_at = torch.gather(q_pad, 1, idx)[:, 0]
    resid = (p_at - q_at).clamp_min(0.0)
    norm = resid.sum(dim=-1, keepdim=True)
    resid = torch.where(norm > 0, resid / norm.clamp_min(1e-20), p_at)
    resample = sample_categorical(gen, torch.log(resid.clamp_min(1e-38)))
    out = torch.cat([draft_tokens.long(),
                     torch.zeros((b, 1), dtype=torch.long,
                                 device=p.device)], dim=1)
    at = torch.arange(k1, device=p.device)[None, :] == accepted[:, None]
    out = torch.where(at, resample[:, None], out)
    return accepted, out


def truncate_draft(model, params, n_layers: int = 2):
    """A self-speculative draft: the target's first ``n_layers`` blocks
    with shared embedding, final norm and LM head (LayerSkip-style early
    exit).  Returns ``(draft_model, draft_params)`` on the target's
    device, with its kernels switch.  Every draft tensor is a view of a
    target tensor (the block stack's first ``n_layers`` rows), so the
    draft takes no weight memory of its own."""
    cfg = model.cfg
    if cfg.family != "dense":
        raise ValueError(f"truncate_draft needs a homogeneous dense "
                         f"stack; {cfg.name} is family={cfg.family}")
    if not 0 < n_layers <= cfg.n_layers:
        raise ValueError(f"n_layers={n_layers} not in 1..{cfg.n_layers}")
    dcfg = dataclasses.replace(cfg, n_layers=n_layers,
                               name=f"{cfg.name}-draft{n_layers}")
    dmodel = type(model)(dcfg, model.device, kernels=model.kernels)
    dparams = dict(params)
    dparams["blocks"] = tree_map(lambda a: a[:n_layers], params["blocks"])
    return dmodel, dparams


def damp_upper_layers(params, n_keep: int, damp: float = 0.02):
    """Scale down the residual output projections (``attn.wo``,
    ``ffn.w_down``) of the layers past ``n_keep``.  With the upper
    layers damped, the ``n_keep``-layer truncated draft agrees with the
    full target almost always: a high-acceptance pair from random
    weights, standing in for the distilled draft a deployment would
    train.  Returns new params (the target keeps its full depth and
    per-token cost).  The scale is cast to the weights' dtype before
    the product, as the reference's weakly typed scale is."""
    blocks = dict(params["blocks"])
    n_layers = tree_leaves(blocks)[0].shape[0]
    for grp, name in (("attn", "wo"), ("ffn", "w_down")):
        sub = dict(blocks[grp])
        w = sub[name]
        scale = torch.where(torch.arange(n_layers, device=w.device) < n_keep,
                            1.0, damp).to(w.dtype)
        sub[name] = w * scale[:, None, None]
        blocks[grp] = sub
    return dict(params, blocks=blocks)
