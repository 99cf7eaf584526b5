"""Face reenactment: the per-frame program, batched over target frames.

Counterpart of the JAX package's ``pipeline/reenactment.py`` (the
reference's ``run_inference.py:157-254``): DECA on the target frames → Δp
→ A → synthesis of the shifted W+ code, onto one source identity. The DECA
alignment is the faithful SFD → FAN chain (``fan_params`` and
``s3fd_params``), FAN on the whole frame ("fan_frame", ``fan_params``
alone), landmarks from the preprocessing pass (``target_lms``), or a plain
resize (none of them). :func:`reenact_raw_batch` adds the preprocessing
(SFD → FAN → FFHQ crop) in front, raw frames in, reenacted faces out.

``fan_params`` / ``s3fd_params`` / ``sfd_prep`` / ``fan_prep`` are the
port's :class:`FAN` / :class:`S3FD` modules (the JAX package's parameter
pytrees under the same names). ``mesh=`` (``parallel/mesh.py``) is frame
data parallelism in one process: the frozen nets are copied once to each
of the mesh's devices, every frame batch is split over them on axis 0
(it must divide the mesh), the parts run one after another with no
synchronize between them, and the outputs are gathered in frame order on
the mesh's first device.

Each call of an entry (:func:`make_fused_reenact_fn`, :func:`make_reenact_fn`)
is one ``reenact.call`` span (``utils/profiling.py::span``; ``call`` counts
the entry's calls) over its stage spans: ``reenact.inputs`` (the inputs
onto the device), ``reenact.preprocess`` and ``reenact.outputs`` (raw frames
only: SFD → FAN → FFHQ crop; the 8-bit outputs), and from
:func:`reenact_batch` ``reenact.deca`` (the alignment and DECA's encoder),
``reenact.shift`` (Δp → A) and ``reenact.synthesis``. On one device every
kernel of a call falls in exactly one stage; on a mesh the stages repeat a
part and the parts' copies and the gather lie in the call alone. The spans
exist only while a ``torch.profiler`` session is active.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple

import torch

from ..geometry.directions import DirectionsSpec, make_shift_vector
from ..models.deca.deca import DECA, calculate_shapemodel
from ..models.direction_matrix import DirectionMatrix, direction_matrix_forward
from ..models.face.cropping import landmarks_in_crop
from ..models.face.fan import FAN, ConvBlock
from ..models.face.s3fd import S3FD
from ..ops.fused_conv_block import K3Args, conv_block_args, k3_takes, program_args
from ..parallel.mesh import Mesh, _to, data_parallel
from ..utils.device import DeviceLike, resolve_device
from ..utils.profiling import span
from .alignment import landmark_align, make_fan_align
from .preprocess import preprocess_batch_device
from .synthesis import AnyGenerator, generate_image

OUTPUTS = ("full", "reenact")


def align_for(fan_params: Optional[FAN], s3fd_params: Optional[S3FD] = None,
              compute_dtype: Optional[torch.dtype] = None):
    """The DECA aligner for these nets, returning the ``ok`` mask so that
    ``calculate_shapemodel`` applies the failed-detection sentinel; None
    (the resize) without ``fan_params``. Only the SFD path can fail."""
    if fan_params is None:
        return None
    return make_fan_align(fan_params, s3fd=s3fd_params, compute_dtype=compute_dtype,
                          return_ok=True)


def source_shape(deca: DECA, source_img: torch.Tensor,
                 fan_params: Optional[FAN] = None,
                 s3fd_params: Optional[S3FD] = None):
    """DECA coefficients and angles of the (1, 256, 256, 3) source image in
    [-1, 1], aligned as ``align_for`` says."""
    return calculate_shapemodel(deca, source_img,
                                align_fn=align_for(fan_params, s3fd_params))


def reenact_batch(g: AnyGenerator, a: DirectionMatrix, deca: DECA,
                  spec: DirectionsSpec, source_code: torch.Tensor,
                  params_source: Dict[str, torch.Tensor],
                  angles_source: torch.Tensor,
                  target_imgs: torch.Tensor, *,
                  truncation: float = 0.7,
                  truncation_latent: Optional[torch.Tensor] = None,
                  num_layers_shift: int = 8,
                  compute_dtype: torch.dtype = torch.float32,
                  fan_params: Optional[FAN] = None,
                  s3fd_params: Optional[S3FD] = None,
                  return_target_params: bool = False,
                  target_lms: Optional[torch.Tensor] = None,
                  target_ok: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Reenact a batch of target frames onto one source identity.

    source_code: (1, n_latent, 512) W+ of the source; params_source /
    angles_source: DECA outputs for the source (batch 1); target_imgs:
    (T, 256, 256, 3) in [-1, 1]; target_lms / target_ok: (T, 68, 2)
    landmarks in target-image coordinates and their (T,) mask, used for the
    DECA alignment instead of a second SFD + FAN pass.

    Returns (reenacted (T, 256, 256, 3), shifted latents (T, n_latent, 512));
    with ``return_target_params`` also (params_target, angles_target).
    ``compute_dtype`` bf16 runs SFD, FAN, the DECA trunk and the synthesis
    in bf16; boxes, heatmap peaks, coefficients and Δp stay float32.
    """
    t = target_imgs.shape[0]
    align_dtype = None if compute_dtype == torch.float32 else compute_dtype
    with span("reenact.deca"):
        if target_lms is not None:
            def align_fn(imgs01):
                return landmark_align(imgs01, target_lms, target_ok)
        else:
            align_fn = align_for(fan_params, s3fd_params, compute_dtype=align_dtype)
        params_target, angles_target = calculate_shapemodel(
            deca, target_imgs, align_fn=align_fn, compute_dtype=align_dtype)

    with span("reenact.shift"):
        ps = {k: v.expand((t,) + tuple(v.shape[1:])) for k, v in params_source.items()}
        angs = angles_source.expand(t, 3)
        delta_p = make_shift_vector(spec, ps, params_target, angs, angles_target)
        shift = direction_matrix_forward(a, delta_p)                 # (T, L, 512)

    with span("reenact.synthesis"):
        codes = source_code.expand((t,) + tuple(source_code.shape[1:]))
        reenacted, shifted_latents = generate_image(
            g, codes, truncation=truncation, truncation_latent=truncation_latent,
            w_plus=True, num_layers_shift=num_layers_shift, shift_code=shift,
            input_is_latent=True, return_latents=True, compute_dtype=compute_dtype)
    if return_target_params:
        return reenacted, shifted_latents, params_target, angles_target
    return reenacted, shifted_latents


def to_u8(images: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images → uint8 with round half up (the device crop's
    quantization; the host float path truncates, at most 1 unit apart)."""
    return torch.floor(torch.clamp((images + 1.0) * 127.5, 0.0, 255.0) + 0.5).to(torch.uint8)


def reenact_raw_batch(g: AnyGenerator, a: DirectionMatrix, deca: DECA,
                      spec: DirectionsSpec, sfd_prep: S3FD, fan_prep: FAN,
                      source_code: torch.Tensor,
                      params_source: Dict[str, torch.Tensor],
                      angles_source: torch.Tensor,
                      raw_frames: torch.Tensor, *,
                      crop_size: int = 256,
                      truncation: float = 0.7,
                      truncation_latent: Optional[torch.Tensor] = None,
                      num_layers_shift: int = 8,
                      compute_dtype: torch.dtype = torch.float32,
                      fan_params: Optional[FAN] = None,
                      s3fd_params: Optional[S3FD] = None,
                      reuse_landmarks: bool = False,
                      output_u8: bool = False,
                      outputs: str = "full"):
    """The whole per-frame path: raw frames in, reenacted faces out.

    Preprocessing (SFD on the raw frame → FAN → FFHQ crop,
    ``utils_inference.py:61-82``) then :func:`reenact_batch` on the crops.
    raw_frames: (T, H, W, 3) uint8 or float RGB at the detection
    resolution. With ``reuse_landmarks`` the preprocessing landmarks, mapped
    into the crop, feed the DECA alignment instead of a second SFD + FAN.

    ``outputs``:
      * "full": (reenacted (T, s, s, 3), latents, crops_u8 (T, crop, crop,
        3), ok (T,), in_frame (T,), landmarks (T, 68, 2));
      * "reenact": (reenacted uint8, ok, in_frame, landmarks).
    ``in_frame`` is False where the FFHQ box leaves the frame: those crops
    are edge-clamped approximations of the host crop. ``output_u8`` returns
    the reenacted images as uint8.
    """
    if outputs not in OUTPUTS:
        raise ValueError(f"outputs must be one of {OUTPUTS}, got {outputs!r}")
    align_dtype = None if compute_dtype == torch.float32 else compute_dtype
    with span("reenact.preprocess"):
        crops_gan, ok, in_frame, pts = preprocess_batch_device(
            sfd_prep, fan_prep, raw_frames, image_size=crop_size, compute_dtype=align_dtype)
        if reuse_landmarks:
            lms_crop, _ = landmarks_in_crop(pts, image_size=crop_size)
    kw = dict(truncation=truncation, truncation_latent=truncation_latent,
              num_layers_shift=num_layers_shift, compute_dtype=compute_dtype)
    if reuse_landmarks:
        reenacted, latents = reenact_batch(
            g, a, deca, spec, source_code, params_source, angles_source, crops_gan,
            target_lms=lms_crop, target_ok=ok, **kw)
    else:
        reenacted, latents = reenact_batch(
            g, a, deca, spec, source_code, params_source, angles_source, crops_gan,
            fan_params=fan_params, s3fd_params=s3fd_params, **kw)
    with span("reenact.outputs"):
        crops_u8 = to_u8(crops_gan)          # the integer-valued crops, exactly
        if output_u8 or outputs == "reenact":
            reenacted = to_u8(reenacted)
    if outputs == "reenact":
        return reenacted, ok, in_frame, pts
    return reenacted, latents, crops_u8, ok, in_frame, pts


def _prepare(modules, device: DeviceLike, truncation_latent, mesh: Optional[Mesh]):
    """(the device the calls run on: the mesh's first device, or
    ``device``; the truncation latent there). The modules are moved there
    in eval mode."""
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    for m in modules:
        if m is not None:
            m.to(dev).eval()
    trunc = None if truncation_latent is None else torch.as_tensor(truncation_latent).to(dev)
    return dev, trunc


def _over_mesh(body, mesh: Optional[Mesh], nets, n_batch: int):
    """``body(*batch, *nets, *rest)`` as it is, or split over the mesh: its
    first ``n_batch`` arguments are the frame batch, ``nets`` are copied to
    every device now."""
    if mesh is None:
        return body
    return data_parallel(body, mesh, batch_argnums=tuple(range(n_batch)),
                         replicated=[m for m in nets if isinstance(m, torch.nn.Module)])


def _entry_call(dev: torch.device, run):
    """Both entries' call: ``call(lead, source_code, params_source,
    angles_source)`` runs ``run(*lead(to_dev), <the source's three>)``, all
    put on ``dev`` in ``reenact.inputs`` (``to_dev``: float32 by default),
    under ``torch.inference_mode()`` and the entry's ``reenact.call``."""
    calls = itertools.count()

    def to_dev(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def call(lead, source_code, params_source, angles_source):
        with torch.inference_mode(), span("reenact.call", call=next(calls)):
            with span("reenact.inputs"):
                args = (*lead(to_dev), to_dev(source_code),
                        {k: to_dev(v) for k, v in params_source.items()}, to_dev(angles_source))
            return run(*args)

    return call


def make_fused_reenact_fn(g: AnyGenerator, a: DirectionMatrix, deca: DECA,
                          spec: DirectionsSpec, sfd_prep: S3FD, fan_prep: FAN, *,
                          crop_size: int = 256,
                          truncation: float = 0.7,
                          truncation_latent: Optional[torch.Tensor] = None,
                          num_layers_shift: int = 8,
                          compute_dtype: torch.dtype = torch.float32,
                          fan_params: Optional[FAN] = None,
                          s3fd_params: Optional[S3FD] = None,
                          reuse_landmarks: bool = False,
                          output_u8: bool = False, mesh=None,
                          outputs: str = "full",
                          device: DeviceLike = None):
    """``fn(source_code, params_source, angles_source, raw_frames)`` → the
    outputs of :func:`reenact_raw_batch`, under ``torch.inference_mode()``
    on ``device`` (the CUDA card by default; it raises when there is
    none). The modules are moved there; inputs may be numpy arrays or
    tensors (uint8 frames stay uint8 until they are on the device)."""
    if outputs not in OUTPUTS:
        raise ValueError(f"outputs must be one of {OUTPUTS}, got {outputs!r}")
    nets = (g, a, deca, sfd_prep, fan_prep, fan_params, s3fd_params)
    dev, trunc = _prepare(nets, device, truncation_latent, mesh)

    def body(raw_frames, g, a, deca, sfd_prep, fan_prep, fan_params, s3fd_params, trunc,
             source_code, params_source, angles_source):
        return reenact_raw_batch(
            g, a, deca, spec, sfd_prep, fan_prep, source_code, params_source, angles_source,
            raw_frames, crop_size=crop_size, truncation=truncation, truncation_latent=trunc,
            num_layers_shift=num_layers_shift, compute_dtype=compute_dtype,
            fan_params=fan_params, s3fd_params=s3fd_params, reuse_landmarks=reuse_landmarks,
            output_u8=output_u8, outputs=outputs)

    call = _entry_call(dev, _over_mesh(body, mesh, nets, 1))

    def fn(source_code, params_source, angles_source, raw_frames):
        return call(lambda to_dev: (torch.as_tensor(raw_frames, device=dev), *nets, trunc),
                    source_code, params_source, angles_source)

    return fn


def k3_blocks(fan: Optional[FAN]) -> List[ConvBlock]:
    """FAN's channels-equal 256-channel ConvBlocks, in module order: the
    blocks K3 takes (14 a module)."""
    if fan is None:
        return []
    return [m for m in fan.modules() if isinstance(m, ConvBlock) and k3_takes(m)]


def module_state(m: Optional[torch.nn.Module]) -> Optional[Dict[str, torch.Tensor]]:
    """``m``'s parameters and persistent buffers by state-dict name,
    detached (they share storage with ``m``)."""
    if m is None:
        return None
    return {k: v.detach() for k, v in m.state_dict(keep_vars=True).items()}


class ReenactProgram(torch.nn.Module):
    """The modules of one reenactment program and the constants made for it
    once: the truncation latent and, for each of FAN's K3 blocks
    (:func:`k3_blocks`), its K3Args in the alignment dtype
    (``ops/fused_conv_block.py::conv_block_args``: ``k3.b{i}_{inv,off,wk}{1,2,3}``;
    the OIHW weights too, ``w``, where that dtype is not float32). Its forward
    is :func:`reenact_batch` with FAN's blocks taken through K3 with those
    constants (``ops/fused_conv_block.py::program_args``) on every device."""

    def __init__(self, g: AnyGenerator, a: DirectionMatrix, deca: DECA, spec: DirectionsSpec,
                 fan: Optional[FAN], s3fd: Optional[S3FD],
                 truncation_latent: Optional[torch.Tensor], *, truncation: float,
                 num_layers_shift: int, compute_dtype: torch.dtype,
                 return_target_params: bool, reuse_landmarks: bool):
        super().__init__()
        self.g, self.a, self.deca, self.fan, self.s3fd = g, a, deca, fan, s3fd
        self.register_buffer("truncation_latent", truncation_latent)
        self.spec, self.truncation, self.num_layers_shift = spec, truncation, num_layers_shift
        self.compute_dtype = compute_dtype
        self.return_target_params, self.reuse_landmarks = return_target_params, reuse_landmarks
        self.k3 = torch.nn.Module()
        self._blocks = [] if reuse_landmarks else k3_blocks(fan)
        self._own_w = compute_dtype != torch.float32
        names = ("inv", "off", "wk") + (("w",) if self._own_w else ())
        with torch.no_grad():
            for i, blk in enumerate(self._blocks):
                args = conv_block_args(blk, compute_dtype)
                for j in range(3):
                    for name in names:
                        self.k3.register_buffer(f"b{i}_{name}{j + 1}", getattr(args, name)[j])

    def block_args(self) -> Dict[ConvBlock, K3Args]:
        """Each K3 block's K3Args from this program's (possibly swapped)
        tensors."""
        k3, out = self.k3, {}
        for i, blk in enumerate(self._blocks):
            def get(name):
                return tuple(getattr(k3, f"b{i}_{name}{j}") for j in (1, 2, 3))
            w = get("w") if self._own_w else tuple(
                getattr(blk, f"conv{j}").weight for j in (1, 2, 3))
            out[blk] = K3Args(get("inv"), get("off"), w, get("wk"))
        return out

    def forward(self, source_code, params_source, angles_source, target_imgs,
                target_lms=None, target_ok=None):
        with program_args(self.block_args()):
            return reenact_batch(
                self.g, self.a, self.deca, self.spec, source_code, params_source,
                angles_source, target_imgs, truncation=self.truncation,
                truncation_latent=self.truncation_latent,
                num_layers_shift=self.num_layers_shift, compute_dtype=self.compute_dtype,
                fan_params=self.fan, s3fd_params=self.s3fd,
                return_target_params=self.return_target_params,
                target_lms=target_lms, target_ok=target_ok)

    def weights(self) -> Dict[str, object]:
        """The tree of every tensor the program reads: ``g``, ``a``,
        ``deca``, ``fan``, ``s3fd`` (state dicts, None where absent),
        ``truncation_latent`` and ``k3``."""
        return {"g": module_state(self.g), "a": module_state(self.a),
                "deca": module_state(self.deca), "fan": module_state(self.fan),
                "s3fd": module_state(self.s3fd), "truncation_latent": self.truncation_latent,
                "k3": module_state(self.k3)}


def flat_weights(weights: Dict[str, object]) -> Dict[str, torch.Tensor]:
    """A weights tree as ``torch.func.functional_call`` takes it: each
    tensor under its dotted name in :class:`ReenactProgram`."""
    flat = {}
    for top, sub in weights.items():
        if isinstance(sub, dict):
            flat.update({f"{top}.{k}": v for k, v in sub.items()})
        elif sub is not None:
            flat[top] = sub
    return flat


def make_reenact_program(g: AnyGenerator, a: DirectionMatrix, deca: DECA,
                         spec: DirectionsSpec, *, truncation: float = 0.7,
                         truncation_latent: Optional[torch.Tensor] = None,
                         num_layers_shift: int = 8,
                         compute_dtype: torch.dtype = torch.float32,
                         fan_params: Optional[FAN] = None,
                         s3fd_params: Optional[S3FD] = None,
                         return_target_params: bool = False,
                         reuse_landmarks: bool = False,
                         device: DeviceLike = None):
    """The reenactment program and its weights: ``(fn, weights)``.

    ``fn(weights, source_code, params_source, angles_source, target_imgs[,
    target_lms, target_ok])`` is one program over a batch of target frames
    (tensors on ``device``, the CUDA card by default), computing
    :func:`reenact_batch`; ``weights`` (:meth:`ReenactProgram.weights`) is
    the tree of every tensor it reads, passed back in as an argument, as
    the JAX package's program takes its weights, so that a serving bundle
    (``serving.py``) stores them apart from the exported program and can
    swap the generator. The weights given are run as they are through
    ``torch.func.functional_call``; the tree returned here runs the modules
    directly. ``fn.program`` is the :class:`ReenactProgram`. The program
    reads no tensor's value in Python, so ``torch.export`` traces it.
    """
    nets = (g, a, deca, fan_params, s3fd_params)
    dev, trunc = _prepare(nets, device, truncation_latent, None)
    prog = ReenactProgram(g, a, deca, spec, fan_params, s3fd_params, trunc,
                          truncation=truncation, num_layers_shift=num_layers_shift,
                          compute_dtype=compute_dtype,
                          return_target_params=return_target_params,
                          reuse_landmarks=reuse_landmarks).to(dev).eval()
    own = prog.weights()

    def fn(weights, source_code, params_source, angles_source, target_imgs, *extra):
        if len(extra) != (2 if reuse_landmarks else 0):
            raise TypeError("the program takes target_lms and target_ok after "
                            "target_imgs with reuse_landmarks, and nothing else")
        args = (source_code, params_source, angles_source, target_imgs) + tuple(extra)
        if weights is own:
            return prog(*args)
        return torch.func.functional_call(prog, flat_weights(weights), args, strict=False)

    fn.program = prog
    return fn, own


def make_reenact_fn(g: AnyGenerator, a: DirectionMatrix, deca: DECA,
                    spec: DirectionsSpec, *, truncation: float = 0.7,
                    truncation_latent: Optional[torch.Tensor] = None,
                    num_layers_shift: int = 8,
                    compute_dtype: torch.dtype = torch.float32,
                    fan_params: Optional[FAN] = None,
                    s3fd_params: Optional[S3FD] = None, mesh=None,
                    return_target_params: bool = False,
                    reuse_landmarks: bool = False,
                    device: DeviceLike = None):
    """Reenactor ``fn(source_code, params_source, angles_source,
    target_imgs[, target_lms, target_ok]) → (reenacted, latents)`` (the
    last two with ``reuse_landmarks``) running :func:`make_reenact_program`'s
    program under ``torch.inference_mode()`` on ``device`` (the CUDA card by
    default; it raises when there is none). ``fan_params`` aligns DECA with
    FAN on the target frames, ``s3fd_params`` too with the SFD-crop → FAN
    chain. The modules are moved onto ``device``; inputs may be numpy
    arrays or tensors, and outputs are tensors there. With ``mesh`` the
    weights are copied once to each of its devices.
    """
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    program, weights = make_reenact_program(
        g, a, deca, spec, truncation=truncation, truncation_latent=truncation_latent,
        num_layers_shift=num_layers_shift, compute_dtype=compute_dtype,
        fan_params=fan_params, s3fd_params=s3fd_params,
        return_target_params=return_target_params, reuse_landmarks=reuse_landmarks,
        device=dev)
    copies = {_placed(dev): weights}
    for d in (mesh.devices if mesh is not None else ()):
        if _placed(d) not in copies:
            copies[_placed(d)] = _to(weights, d, {})

    def body(target_imgs, lms, ok, source_code, params_source, angles_source):
        extra = (lms, ok) if reuse_landmarks else ()
        return program(copies[target_imgs.device], source_code, params_source,
                       angles_source, target_imgs, *extra)

    call = _entry_call(dev, _over_mesh(body, mesh, (), 3))

    def fn(source_code, params_source, angles_source, target_imgs, *extra):
        if len(extra) != (2 if reuse_landmarks else 0):
            raise TypeError("the reenactor takes target_lms and target_ok after "
                            "target_imgs with reuse_landmarks, and nothing else")

        def lead(to_dev):
            lms, ok = (to_dev(extra[0]), to_dev(extra[1], torch.bool)) if extra else (None, None)
            return to_dev(target_imgs), lms, ok
        return call(lead, source_code, params_source, angles_source)

    return fn


def _placed(device) -> torch.device:
    """The device a tensor made on ``device`` reports (``cuda`` → ``cuda:0``)."""
    return torch.empty(0, device=device).device
