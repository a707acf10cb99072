"""Traffic kind ``train_corpus``: a training set of utterances of drawn
lengths over chain training graphs, with features drawn along a path
through each.  Parameters: ``seconds`` (shortest and longest),
``seconds_beta`` (the Beta law between them), ``phones_per_second``,
``skip_share``; the runner adds ``num_utts`` and ``states_per_phone`` from
the configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from vbbench.traffic import fixed_set


def utterance_frames(spec: dict, gen, device) -> torch.Tensor:
    """Frame counts ``[U]``: lo + (hi - lo) * Beta(a, b) seconds, 100 frames
    a second, the same set for every seed (``fixed_set``)."""
    u = int(spec["num_utts"])
    lo, hi = spec["seconds"]
    a, b = spec["seconds_beta"]

    def draw(g):
        full = torch.full((u,), 1.0, device=device, dtype=torch.float64)
        ga = torch._standard_gamma(full * float(a), generator=g)
        gb = torch._standard_gamma(full * float(b), generator=g)
        return torch.round((lo + (hi - lo) * ga / (ga + gb)) * 100).long()

    return fixed_set(draw, gen, device)


def corpus(spec: dict, model: dict, roots: dict, gen, device) -> dict:
    """The training set: for every utterance a chain of phone states (its
    training graph) and features drawn from ``model`` along a path through
    it.  Phones are drawn uniformly, each of ``spec["states_per_phone"]``
    states a pdf of the phone's root for that state in proportion to the
    pdfs' occupancy shares (``roots["cum_share"]``); a state is entered by a
    skip over its predecessor with probability ``spec["skip_share"]``.  The
    path visits every state, the frames beyond one a state spread over the
    states at random; each frame draws a Gaussian of its pdf by weight and
    a point from it.

    Returns numpy ``num_frames [U]``, ``num_states [U]``, ``state_pdf``,
    ``skip`` (flat over the utterances' states, in order)
    and the padded features ``[U, T_max, D]`` on the device."""
    frames = utterance_frames(spec, gen, device)
    spp = int(spec["states_per_phone"])
    phones = torch.clamp_min(torch.round(frames * float(spec["phones_per_second"]) / 100), 1).long()
    states = phones * spp
    states = torch.minimum(states, frames - frames % spp)  # a path needs a frame a state
    u, total = len(frames), int(states.sum())
    utt_of_state = torch.repeat_interleave(torch.arange(u, device=device), states)
    first = torch.cumsum(states, 0) - states
    pos = torch.arange(total, device=device) - first[utt_of_state]
    num_phones = int(roots["num_phones"])
    phone = torch.randint(0, num_phones, (total // spp,), generator=gen, device=device)
    root = torch.repeat_interleave(phone, spp) * spp + pos % spp
    # a pdf of the root, in proportion to the pdfs' shares
    cum = torch.as_tensor(roots["cum_share"], device=device)  # [R, K] cumulative, rows sum 1
    members = torch.as_tensor(roots["members"], device=device)  # [R, K] pdf ids, -1 padding
    pick = torch.searchsorted(cum[root], torch.rand((total, 1), generator=gen, device=device,
                                                    dtype=cum.dtype)).clamp_max(cum.shape[1] - 1)
    pdf = members[root, pick[:, 0]]
    skip = (pos >= 2) & (torch.rand(total, generator=gen, device=device) < float(spec["skip_share"]))
    # durations: one frame a state, the rest spread at random
    extra = frames - states
    owner = torch.repeat_interleave(torch.arange(u, device=device), extra)
    at = (torch.rand(len(owner), generator=gen, device=device, dtype=torch.float64)
          * states[owner]).long()
    dur = 1 + torch.bincount(first[owner] + at, minlength=total)
    frame_state = torch.repeat_interleave(torch.arange(total, device=device), dur)
    frame_pdf = pdf[frame_state]
    t_max = int(frames.max())
    d = model["means"].shape[2]
    feats = torch.zeros((u, t_max, d), dtype=torch.float32, device=device)
    utt_of_frame = utt_of_state[frame_state]
    t_of_frame = torch.arange(len(frame_state), device=device) - (
        torch.cumsum(frames, 0) - frames)[utt_of_frame]
    mean = torch.as_tensor(model["means"], device=device, dtype=torch.float32)
    std = torch.as_tensor(model["vars"], device=device, dtype=torch.float32).sqrt()
    cw = torch.cumsum(torch.as_tensor(model["weights"], device=device, dtype=torch.float32), 1)
    block = 1 << 21
    for lo in range(0, len(frame_pdf), block):
        p = frame_pdf[lo:lo + block]
        r = torch.rand((len(p), 1), generator=gen, device=device) * cw[p, -1:]
        comp = torch.searchsorted(cw[p], r).clamp_max(cw.shape[1] - 1)[:, 0]
        z = torch.randn((len(p), d), generator=gen, device=device)
        feats[utt_of_frame[lo:lo + block], t_of_frame[lo:lo + block]] = mean[p, comp] + std[p, comp] * z
    return {"num_frames": frames.cpu().numpy().astype(np.int32),
            "num_states": states.cpu().numpy().astype(np.int32),
            "state_pdf": pdf.cpu().numpy().astype(np.int32),
            "skip": skip.cpu().numpy(), "feats": feats}
