"""The training steps of the direction matrix A for the four methods (the
reference's ``libs/trainer.py:135-405``; the JAX package's
``train/steps.py``).

A step samples or takes its inputs, reads DECA's coefficients on both
sides under no-grad, forms Δp, shifts the source's code by A(Δp),
synthesizes the shifted image, reads its coefficients with grad, and
differentiates the loss stack back to A: loss → FLAME → ResNet-50 → warp →
image → StyleGAN2 (K1-bwd, K2-bwd) → W+ shift → A. The optimizer is the
reference's ``Adam(lr, weight_decay=5e-4)`` (``trainer.py:144``).

Every step takes its randomness from one sampler, :func:`sample_draws`,
whose :class:`Draws` the step's body is a function of: ``step(a, gen,
*extra)`` draws from the ``torch.Generator`` ``gen``, and ``step(a, None,
*extra, draws=d)`` runs on given draws.

Data parallelism (the JAX package's mesh, here a process world of
``torch.distributed``, ``parallel/mesh.py``): ``args.batch_size`` is the
global batch. Every rank draws the global batch's draws from the same
generator and keeps its rows (:func:`batch_halves` says which), takes its
rows of the inputs from the Trainer, and the optimizer step averages A's
gradient (one all-reduce) and the loss terms over the world, so a world of
P makes one card's update and logs one card's terms. An accumulated step
reduces once, after its last microbatch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.arguments import TrainingArguments
from ..geometry.directions import (DirectionsSpec, draw_disentanglement_50,
                                   make_shift_vector, make_shift_vector_50_from)
from ..losses.lpips import LPIPS
from ..models.deca.deca import DECA, calculate_shapemodel
from ..models.direction_matrix import DirectionMatrix, direction_matrix_forward
from ..models.face.fan import FAN
from ..models.face.s3fd import S3FD
from ..models.irse import Backbone
from ..models.stylegan2 import Generator, mapping
from ..parallel.mesh import average_over_world, shard_batch, world_info
from ..pipeline.synthesis import generate_image
from .losses_stack import calculate_losses, calculate_losses_paired

Coeffs = Dict[str, torch.Tensor]


@dataclasses.dataclass
class FrozenModels:
    """The frozen nets of a step. Building it puts each net in eval mode
    and stops its parameters' gradients (and detaches the mean latent), so
    only A is trained and FAN's blocks take K3's served route (no K3-bwd). ``fan`` (and ``s3fd``) give
    DECA the reference's alignment (``decalib/datasets/datasets.py:57-86``);
    without them DECA takes a bilinear resize."""
    generator: Generator
    deca: DECA
    id_backbone: Backbone
    lpips: LPIPS
    truncation_latent: torch.Tensor
    fan: Optional[FAN] = None
    s3fd: Optional[S3FD] = None

    def __post_init__(self):
        self.truncation_latent = self.truncation_latent.detach()
        for net in (self.generator, self.deca, self.id_backbone, self.lpips, self.fan,
                    self.s3fd):
            if net is not None:
                net.eval().requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.truncation_latent.device


class Draws(NamedTuple):
    """A step's random inputs: z's of the synthetic source, the target and
    the real_synthetic half, and the disentanglement-50 picks (direction
    indices and uniform positions, each (B/2,))."""
    z_src: Optional[torch.Tensor] = None
    z_tgt: Optional[torch.Tensor] = None
    z_syn: Optional[torch.Tensor] = None
    target_indices: Optional[torch.Tensor] = None
    u: Optional[torch.Tensor] = None


def batch_halves(args: TrainingArguments, method: str) -> bool:
    """Whether a step's batch is two halves treated differently: the
    disentanglement-50 halves of the unpaired methods, and real_synthetic's
    real and synthetic halves. A rank's rows of such a batch are its block
    of each half (``parallel/mesh.py::rank_rows`` with two groups), else
    its block."""
    return method != "paired" and (args.disentanglement_50 or method == "real_synthetic")


def sample_draws(gen: torch.Generator, args: TrainingArguments, spec: DirectionsSpec,
                 device, *, source: bool, target: bool, syn: int = 0,
                 halves: Optional[bool] = None) -> Draws:
    """Draw, in this order, z_src (B, dim_z) when ``source``, z_tgt when
    ``target``, z_syn (``syn``, dim_z), and with disentanglement-50 the
    (B/2,) direction indices and positions, from ``gen`` on its device. In
    a world of several ranks every rank draws the same and keeps its rows:
    of z_src and z_tgt its block of each half when ``halves`` (default: with
    disentanglement-50), else its block; its block of z_syn and of the
    second half's picks."""
    b = args.batch_size
    halves = args.disentanglement_50 if halves is None else halves

    def z(n):
        return torch.randn((n, args.dim_z), generator=gen, device=gen.device).to(device)

    d = Draws(z_src=z(b) if source else None, z_tgt=z(b) if target else None,
              z_syn=z(syn) if syn else None)
    if args.disentanglement_50:
        if b % 2:
            raise ValueError("batch size must be even for disentanglement_50")
        idx, u = draw_disentanglement_50(spec, b // 2, gen, device)
        d = d._replace(target_indices=idx, u=u)
    if world_info()[1] > 1:
        parts = 2 if halves else 1
        d = Draws(z_src=shard_batch(d.z_src, groups=parts),
                  z_tgt=shard_batch(d.z_tgt, groups=parts),
                  z_syn=shard_batch(d.z_syn), target_indices=shard_batch(d.target_indices),
                  u=shard_batch(d.u))
    return d


def make_align_fn(models: FrozenModels, args: TrainingArguments):
    """DECA's aligner for ``args.deca_alignment``: 'fan' (SFD crop → FAN
    when ``models.s3fd`` is there, FAN on the frame otherwise), 'fan_frame'
    (FAN on the whole frame) or 'resize' (None: a bilinear resize). With
    ``return_ok``, frames where SFD finds no face get zero coefficients and
    the −180° sentinel, as the reference's ``extract_DECA_params``
    (``estimate_DECA.py:33-51``)."""
    mode = args.deca_alignment
    if mode not in ("fan", "fan_frame") or models.fan is None:
        return None
    from ..pipeline.alignment import make_fan_align
    return make_fan_align(models.fan, s3fd=models.s3fd if mode == "fan" else None,
                          return_ok=True)


def make_optimizer(a: DirectionMatrix, args: TrainingArguments) -> torch.optim.Adam:
    """The reference's optimizer: Adam over A with L2 weight decay added to
    the gradient before the moments."""
    return torch.optim.Adam(a.parameters(), lr=args.lr, weight_decay=args.weight_decay)


def _lambdas(args: TrainingArguments) -> Dict[str, float]:
    return {k: getattr(args, k) for k in (
        "lambda_identity", "lambda_perceptual", "lambda_pixel_wise", "lambda_shape",
        "lambda_mouth_shape", "lambda_eye_shape", "lambda_w_reg")}


def _compute_dtype(args: TrainingArguments) -> torch.dtype:
    return torch.bfloat16 if args.train_compute_dtype == "bfloat16" else torch.float32


def _maybe_remat(args: TrainingArguments, fn):
    """``--remat``: recompute ``fn``'s activations in the backward pass
    (``torch.utils.checkpoint``) instead of keeping them."""
    if not args.remat:
        return fn
    return lambda *xs: checkpoint(fn, *xs, use_reentrant=False)


def _shapemodel(models: FrozenModels, args: TrainingArguments):
    align = make_align_fn(models, args)

    def shapemodel(imgs):
        return calculate_shapemodel(models.deca, imgs, align_fn=align,
                                    image_size=args.deca_image_size)
    return shapemodel


def _shift_vector(spec, args, draws: Draws, p_src, p_tgt, ang_src, ang_tgt):
    if args.disentanglement_50:
        return (make_shift_vector_50_from(spec, p_src, p_tgt, ang_src, ang_tgt,
                                          draws.target_indices, draws.u),
                draws.target_indices)
    return (make_shift_vector(spec, p_src, p_tgt, ang_src, ang_tgt),
            torch.zeros((ang_src.shape[0] // 2,), dtype=torch.long, device=ang_src.device))


def _grad_names(a: DirectionMatrix):
    return [(n.split(".")[-1], p) for n, p in a.named_parameters()]


def _detached(loss_dict):
    return {k: (v.detach() if isinstance(v, torch.Tensor) else torch.tensor(v))
            for k, v in loss_dict.items()}


def _update(a: DirectionMatrix, optimizer, loss_dict):
    """Average A's gradient (in ``.grad``) and the loss terms over the
    world, add the gradient's global L2 norm (the reference's
    ``wandb.watch``) to the terms, and make one optimizer update."""
    names = _grad_names(a)
    keys = list(loss_dict)
    terms = torch.stack([loss_dict[k].detach().float().reshape(()) for k in keys])
    average_over_world([p.grad for _, p in names] + [terms])
    loss_dict = dict(zip(keys, terms.unbind()))
    loss_dict["grad_norm"] = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(p.grad) for _, p in names]))
    optimizer.step()
    return loss_dict


def _finish(loss_fn, sampler, optimizer, grads_only: bool):
    """The step around ``loss_fn(a, draws, *extra) -> (total, terms)``:
    with ``grads_only`` it returns (terms, {"weight", "bias"} gradients) of
    this rank's rows, else it makes one optimizer update of A from the
    world's mean gradient and returns the world's mean terms with the
    gradient's global L2 norm."""
    if not grads_only and optimizer is None:
        raise ValueError("a training step needs its optimizer (make_optimizer)")

    def step(a: DirectionMatrix, gen: Optional[torch.Generator] = None, *extra,
             draws: Optional[Draws] = None):
        if draws is None:
            draws = sampler(gen)
        total, loss_dict = loss_fn(a, draws, *extra)
        names = _grad_names(a)
        if grads_only:
            grads = torch.autograd.grad(total, [p for _, p in names])
            return _detached(loss_dict), {n: g for (n, _), g in zip(names, grads)}
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        return _update(a, optimizer, _detached(loss_dict))

    return step


def _shifted(models, args, code, shift, input_is_latent):
    """(the shifted synthesis, its W+ code)."""
    return generate_image(
        models.generator, code, truncation=args.truncation,
        truncation_latent=models.truncation_latent, shift_code=shift,
        input_is_latent=input_is_latent, return_latents=True,
        num_layers_shift=args.num_layers_shift, w_plus=args.w_plus,
        compute_dtype=_compute_dtype(args))


def _unpaired_loss(models, spec, args, shapemodel, lambdas, code, input_is_latent,
                   p_src, ang_src, p_tgt, shift_vector, target_indices, imgs_source, a):
    """A's forward, the shifted synthesis and the unpaired loss stack."""
    def synth(shift):
        return _shifted(models, args, code, shift, input_is_latent)[0]

    def shape_and_losses(imgs_shifted):
        p_shifted, _ = shapemodel(imgs_shifted)
        return calculate_losses(models.deca, models.id_backbone, models.lpips, spec,
                                lambdas, p_src, ang_src, p_shifted, p_tgt, shift_vector,
                                target_indices, imgs_source, imgs_shifted,
                                disentanglement_50=args.disentanglement_50)

    imgs_shifted = _maybe_remat(args, synth)(direction_matrix_forward(a, shift_vector))
    return _maybe_remat(args, shape_and_losses)(imgs_shifted)


def make_synthetic_step(models: FrozenModels, spec: DirectionsSpec, args: TrainingArguments,
                        optimizer: Optional[torch.optim.Optimizer] = None,
                        grads_only: bool = False) -> Callable:
    """``Trainer.train()``'s step (``trainer.py:151-189``): z-sampled source
    and target; the losses against the source image and the reenacted
    ground-truth coefficients. ``step(a, gen)``."""
    lambdas, shapemodel = _lambdas(args), _shapemodel(models, args)
    dtype = _compute_dtype(args)

    def loss_fn(a, draws: Draws):
        with torch.no_grad():
            imgs_source = generate_image(
                models.generator, draws.z_src, truncation=args.truncation,
                truncation_latent=models.truncation_latent, compute_dtype=dtype)
            p_src, ang_src = shapemodel(imgs_source)
            imgs_target = generate_image(
                models.generator, draws.z_tgt, truncation=args.truncation,
                truncation_latent=models.truncation_latent, compute_dtype=dtype)
            p_tgt, ang_tgt = shapemodel(imgs_target)
            shift_vector, target_indices = _shift_vector(spec, args, draws, p_src, p_tgt,
                                                         ang_src, ang_tgt)
        return _unpaired_loss(models, spec, args, shapemodel, lambdas, draws.z_src, False,
                              p_src, ang_src, p_tgt, shift_vector, target_indices,
                              imgs_source, a)

    def sampler(gen):
        return sample_draws(gen, args, spec, models.device, source=True, target=True)

    return _finish(loss_fn, sampler, optimizer, grads_only)


def make_real_step(models: FrozenModels, spec: DirectionsSpec, args: TrainingArguments,
                   optimizer: Optional[torch.optim.Optimizer] = None,
                   synthetic_half: bool = False, cached_shape: bool = False,
                   grads_only: bool = False) -> Callable:
    """``Trainer.train_real()``'s step (``trainer.py:247-308``): the source is
    real inverted W+ codes and their frames (plus, for 'real_synthetic', a
    z-sampled half), the target a random z. ``step(a, gen, source_w,
    source_real_img)``, and with ``cached_shape`` also the real frames'
    coefficients and angles (the Trainer's cache; the synthetic half and
    the target still run their shape passes in the step)."""
    lambdas, shapemodel = _lambdas(args), _shapemodel(models, args)
    dtype = _compute_dtype(args)
    half = args.batch_size // 2

    def loss_fn(a, draws: Draws, source_w, source_img, *cached):
        p_real, ang_real = cached if cached_shape else (None, None)
        with torch.no_grad():
            imgs_syn = None
            if synthetic_half:
                w_syn = mapping(models.generator, draws.z_syn)
                w_syn = w_syn[:, None, :].repeat(1, source_w.shape[1], 1)
                imgs_syn = generate_image(
                    models.generator, w_syn, truncation=args.truncation,
                    truncation_latent=models.truncation_latent, input_is_latent=True,
                    compute_dtype=dtype)
                source_w = torch.cat([source_w, w_syn], dim=0)
                source_img = torch.cat([source_img, imgs_syn], dim=0)
            if p_real is None:
                p_src, ang_src = shapemodel(source_img)
            elif synthetic_half:
                p_syn, ang_syn = shapemodel(imgs_syn)
                p_src = {k: torch.cat([p_real[k], p_syn[k]], dim=0) for k in p_real}
                ang_src = torch.cat([ang_real, ang_syn], dim=0)
            else:
                p_src, ang_src = p_real, ang_real
            imgs_target = generate_image(
                models.generator, draws.z_tgt, truncation=args.truncation,
                truncation_latent=models.truncation_latent, compute_dtype=dtype)
            p_tgt, ang_tgt = shapemodel(imgs_target)
            shift_vector, target_indices = _shift_vector(spec, args, draws, p_src, p_tgt,
                                                         ang_src, ang_tgt)
        return _unpaired_loss(models, spec, args, shapemodel, lambdas, source_w, True,
                              p_src, ang_src, p_tgt, shift_vector, target_indices,
                              source_img, a)

    def sampler(gen):
        return sample_draws(gen, args, spec, models.device, source=False, target=True,
                            syn=half if synthetic_half else 0,
                            halves=args.disentanglement_50 or synthetic_half)

    return _finish(loss_fn, sampler, optimizer, grads_only)


def make_paired_step(models: FrozenModels, spec: DirectionsSpec, args: TrainingArguments,
                     optimizer: Optional[torch.optim.Optimizer] = None,
                     cached_shape: bool = False, grads_only: bool = False) -> Callable:
    """``Trainer.train_paired()``'s step (``trainer.py:349-397``): source and
    target frames of one video; the losses against the real target frame.
    ``step(a, gen, source_w, source_img, target_w, target_img)``; with
    ``cached_shape``, ``step(a, gen, source_w, target_w, target_img, p_src,
    ang_src, p_tgt, ang_tgt)``: the dataset frames' coefficients are
    training invariants, so the Trainer keeps them and the step runs only
    the shifted image's shape pass (the one under grad). No draws."""
    lambdas, shapemodel = _lambdas(args), _shapemodel(models, args)

    def body(a, source_w, target_w, target_img, p_src, ang_src, p_tgt, ang_tgt):
        with torch.no_grad():
            shift_vector = make_shift_vector(spec, p_src, p_tgt, ang_src, ang_tgt)

        def synth(shift):
            return _shifted(models, args, source_w, shift, True)

        def shape_and_losses(imgs_shifted, shifted_latents):
            p_shifted, _ = shapemodel(imgs_shifted)
            return calculate_losses_paired(models.deca, models.id_backbone, models.lpips,
                                           lambdas, p_shifted, p_tgt, imgs_shifted,
                                           target_img, shifted_latents, target_w)

        imgs_shifted, latents = _maybe_remat(args, synth)(
            direction_matrix_forward(a, shift_vector))
        return _maybe_remat(args, shape_and_losses)(imgs_shifted, latents)

    if cached_shape:
        def loss_fn(a, draws, source_w, target_w, target_img, p_src, ang_src, p_tgt,
                    ang_tgt):
            return body(a, source_w, target_w, target_img, p_src, ang_src, p_tgt, ang_tgt)
    else:
        def loss_fn(a, draws, source_w, source_img, target_w, target_img):
            with torch.no_grad():
                p_src, ang_src = shapemodel(source_img)
                p_tgt, ang_tgt = shapemodel(target_img)
            return body(a, source_w, target_w, target_img, p_src, ang_src, p_tgt, ang_tgt)

    return _finish(loss_fn, lambda gen: Draws(), optimizer, grads_only)


def _check_microbatches(builder, args: TrainingArguments, n_micro: int, builder_kw) -> int:
    """The microbatch size, after checking that every array of a step's
    inputs splits into ``n_micro`` equal parts that are whole batches of
    the microbatch's step, and that each microbatch (each of its halves,
    where it has two) splits over the world's ranks."""
    if args.batch_size % n_micro:
        raise ValueError(f"grad_accum {n_micro} must divide batch_size {args.batch_size}")
    mb = args.batch_size // n_micro
    if builder is make_real_step and builder_kw.get("synthetic_half") and mb % 2:
        # the real half's inputs (batch_size / 2 rows) must split into the
        # microbatches' real halves (mb / 2 rows each)
        raise ValueError(f"real_synthetic's real half ({args.batch_size // 2} rows) does "
                         f"not split into {n_micro} microbatch halves of {mb / 2}")
    if args.disentanglement_50 and builder is not make_paired_step and mb % 2:
        raise ValueError(f"the microbatch {mb} (batch_size / grad_accum) must be even "
                         "for disentanglement_50")
    world = world_info()[1]
    if mb % world:
        raise ValueError(f"microbatch {mb} (batch_size/grad_accum) must divide the "
                         f"{world}-device mesh for data-parallel training")
    method = ("paired" if builder is make_paired_step else
              "real_synthetic" if builder_kw.get("synthetic_half") else "synthetic")
    if world > 1 and batch_halves(args, method) and (mb // 2) % world:
        raise ValueError(f"each half of the microbatch {mb} (batch_size/grad_accum) must "
                         f"divide the {world}-device mesh for data-parallel training: a "
                         "rank takes its rows of each half")
    return mb


def make_accum_step(builder: Callable, models: FrozenModels, spec: DirectionsSpec,
                    args: TrainingArguments,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    n_micro: Optional[int] = None, **builder_kw) -> Callable:
    """Gradient accumulation around any step builder: each batch splits
    into ``n_micro`` (default ``args.grad_accum``) microbatches, the
    builder's grads-only step runs on each, and their mean gradient makes
    ONE optimizer update; every loss of the stack is a batch mean, so the
    update is the whole batch's. The microbatches draw one after another
    from the step's generator. The sizes are checked here, when the step is
    built. In a world of several ranks each microbatch is split over the
    ranks, and the mean gradient is reduced over the world once, after the
    last microbatch (the ``no_sync`` of DDP)."""
    n_micro = max(1, int(n_micro if n_micro is not None else args.grad_accum or 1))
    mb = _check_microbatches(builder, args, n_micro, builder_kw)
    if n_micro == 1:
        return builder(models, spec, args, optimizer, **builder_kw)
    if optimizer is None:
        raise ValueError("an accumulated step needs its optimizer (make_optimizer)")
    mb_args = dataclasses.replace(args, batch_size=mb, grad_accum=1)
    grad_step = builder(models, spec, mb_args, None, grads_only=True, **builder_kw)

    def part(x, i):
        if isinstance(x, dict):
            return {k: part(v, i) for k, v in x.items()}
        k = x.shape[0] // n_micro
        return x[i * k:(i + 1) * k]

    def step(a: DirectionMatrix, gen: Optional[torch.Generator] = None, *extra):
        gsum, lsum = None, None
        for i in range(n_micro):
            ld, g = grad_step(a, gen, *(part(x, i) for x in extra))
            gsum = g if gsum is None else {k: gsum[k] + g[k] for k in g}
            lsum = ld if lsum is None else {k: lsum[k] + ld[k] for k in ld}
        optimizer.zero_grad(set_to_none=True)
        for n, p in _grad_names(a):
            p.grad = gsum[n] / n_micro
        return _update(a, optimizer, {k: v / n_micro for k, v in lsum.items()})

    return step


def make_shape_program(models: FrozenModels, args: TrainingArguments):
    """The alignment and DECA encode of a batch of [-1, 1] images under
    no-grad: the Trainer's cache fill for ``cached_shape`` training (the
    steps' own shape pass)."""
    shapemodel = _shapemodel(models, args)

    def shape(imgs: torch.Tensor) -> Tuple[Coeffs, torch.Tensor]:
        with torch.no_grad():
            return shapemodel(imgs)
    return shape
