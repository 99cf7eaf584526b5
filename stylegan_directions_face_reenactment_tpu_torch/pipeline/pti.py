"""PTI: per-identity fine-tuning of the generator on the source pivot.

PyTorch counterpart of ``stylegan_directions_face_reenactment_tpu/pipeline/
pti.py`` (the reference's ``optimization.py:25-72``, ``optimize_g``): Adam
over the parameters of ``convs[4..11]`` (the StyledConvs from 32² to 256² of
a 256² generator) for 200 steps of 100·MSE + LPIPS between the synthesis of
the pivot code and the real source crop. The JAX package runs the loop as
one ``lax.scan``; here it is a Python loop of eager steps whose backward
goes through K1 and K2 on the card (``ops/upfirdn2d_kernel.py``,
``ops/fused_act.py``). ``torch.optim.Adam`` with optax's defaults computes
optax's update.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from ..losses.lpips import LPIPS
from ..losses.pti import pti_loss
from ..models.nn import resize_bilinear
from ..models.stylegan2 import Generator
from .synthesis import generate_image

TUNED_CONV_RANGE = (4, 12)  # convs[4..11] (`optimization.py:31-36`)


def split_tunable(g: Generator, optimize_all: bool = False) -> List[nn.Parameter]:
    """The parameters PTI tunes: with ``optimize_all`` every parameter of
    ``g``, else those of ``convs[4..11]`` (conv weight, modulation weight and
    bias, noise weight, activation bias). The noise maps are buffers, as in
    the reference, and are never tuned (the JAX package's ``optimize_all``
    tunes them too, since they sit among its parameters)."""
    if optimize_all:
        return list(g.parameters())
    lo, hi = TUNED_CONV_RANGE
    return [p for conv in g.convs[lo:hi] for p in conv.parameters()]


def pti_objective(g: Generator, latent: torch.Tensor, real_imgs: torch.Tensor,
                  lpips_params: LPIPS, truncation_latent: torch.Tensor, *,
                  truncation: float = 0.7, pt_l2_lambda: float = 100.0,
                  compute_dtype: torch.dtype = torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, MSE, LPIPS) of one PTI step: synthesize ``latent`` (W+) with
    truncation, resize to the pivot's size when the generator's differs
    (test-scale generators; the >256 ones are pooled to 256 by
    ``generate_image``), and compare with ``real_imgs`` (NHWC in [-1, 1])."""
    imgs = generate_image(g, latent, truncation=truncation,
                          truncation_latent=truncation_latent, input_is_latent=True,
                          compute_dtype=compute_dtype)
    if imgs.shape[1] != real_imgs.shape[1]:
        imgs = resize_bilinear(imgs.permute(0, 3, 1, 2),
                               real_imgs.shape[1:3]).permute(0, 2, 3, 1)
    return pti_loss(lpips_params, imgs, real_imgs, pt_l2_lambda=pt_l2_lambda)


def optimize_g(g_params: Generator, latent: torch.Tensor, real_imgs: torch.Tensor,
               lpips_params: LPIPS, truncation_latent: torch.Tensor, *,
               opt_steps: int = 200, lr: float = 3e-3, optimize_all: bool = False,
               truncation: float = 0.7, compute_dtype: torch.dtype = torch.float32
               ) -> Tuple[Generator, Dict[str, torch.Tensor]]:
    """Fine-tune a copy of ``g_params`` on one (latent, image) pivot; the
    caller's generator is not changed. latent: (B, n_latent, 512) W+;
    real_imgs: (B, H, W, 3) in [-1, 1]; both on the generator's device.

    Returns (the tuned copy, with every parameter frozen again, and the
    final losses ``loss``, ``l2_loss``, ``lpips_loss`` with
    ``loss_history``, the total of every step). Inputs made under
    ``torch.inference_mode()`` are copied, since autograd cannot save them.
    """
    pt_l2_lambda = 1.0 if optimize_all else 100.0  # `optimization.py:36-40`
    g = copy.deepcopy(g_params)
    g.requires_grad_(False)
    tunable = split_tunable(g, optimize_all)
    for p in tunable:
        p.requires_grad_(True)
    latent, real_imgs, trunc = (t.detach().clone() for t in
                                (latent, real_imgs, truncation_latent))
    opt = torch.optim.Adam(tunable, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    totals, l2s, lps = [], [], []
    for _ in range(opt_steps):
        opt.zero_grad(set_to_none=True)
        total, l2v, lp = pti_objective(g, latent, real_imgs, lpips_params, trunc,
                                       truncation=truncation, pt_l2_lambda=pt_l2_lambda,
                                       compute_dtype=compute_dtype)
        total.backward()
        opt.step()
        totals.append(total.detach())
        l2s.append(l2v.detach())
        lps.append(lp.detach())
    g.requires_grad_(False)
    history = torch.stack(totals)
    return g, {"loss": history[-1], "l2_loss": l2s[-1], "lpips_loss": lps[-1],
               "loss_history": history}
