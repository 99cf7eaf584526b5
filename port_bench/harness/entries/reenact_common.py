"""What the two reenactment entries share: the source identity from the
seed, the stage spans, the FLOP count and the comparison with the
reference.

The comparison follows the program's outputs stage by stage, as a served
model's tokens are followed, over every frame of the sampled chunks: the
reference detects and finds landmarks on the same raw frames, cuts the
crops at the program's landmarks, runs DECA → Δp → A on the program's
crops against a source it builds itself from the seed, and synthesizes
the program's latents."""

from __future__ import annotations

import importlib
from typing import Dict

import torch

from .. import common, nets, traffic
from ..trace import cuda_ms
from ..work import count_flops as flops_of

NETS = ("g", "a", "deca", "sfd", "fan")
SHIFT_FRAME = 0.008   # a frame whose shift departs by more than this is off


def trunc_rng(seed: int) -> torch.Generator:
    """The host generator of the truncation latent's 4096 z's."""
    return torch.Generator().manual_seed(seed * 8 + 5)


def source_z(run) -> torch.Tensor:
    gen = traffic.generator(run.seed, 6, run.device)
    return torch.randn(1, run.cfg["generator"]["style_dim"], generator=gen, device=run.device)


def port_source(run, n: Dict):
    sg = importlib.import_module(f"{common.PORT}.models.stylegan2")
    pipe = importlib.import_module(f"{common.PORT}.pipeline")
    geo = importlib.import_module(f"{common.PORT}.geometry")
    d = run.cfg["directions"]
    spec = geo.initialize_directions(d["dataset"], d["learned_directions"], d["shift_scale"])
    with torch.inference_mode():
        trunc = sg.mean_latent(n["g"], trunc_rng(run.seed), 4096)
        code = sg.style_to_wplus(n["g"], [sg.mapping(n["g"], source_z(run))])
        params, angles = pipe.source_shape(n["deca"], sg.synthesis(n["g"], code),
                                           n["fan"], n["sfd"])
    return (code, params, angles), trunc, spec


def stage_spans(run, raw: bool) -> None:
    """Device ms (CUDA events, median of 3) of one chunk through the stage
    functions the entry composes: preprocessing (raw frames only), DECA
    aligned by SFD + FAN, and the synthesis of the shifted code."""
    pipe = importlib.import_module(f"{common.PORT}.pipeline")
    geo = importlib.import_module(f"{common.PORT}.geometry")
    deca_m = importlib.import_module(f"{common.PORT}.models.deca.deca")
    dm = importlib.import_module(f"{common.PORT}.models.direction_matrix")
    st, n, d = run.state, run.state["nets"], run.cfg["directions"]
    code, params_s, angles_s = st["src"]
    dtype = torch.bfloat16 if run.control else torch.float32
    align_dtype = None if dtype == torch.float32 else dtype
    chunk = run.tr["chunk"]
    with torch.inference_mode():
        if raw:
            frames = st["pool"][:chunk].to(run.device)
            run.readings["preprocess_ms"] = cuda_ms(lambda: pipe.preprocess_batch_device(
                n["sfd"], n["fan"], frames, compute_dtype=align_dtype))
            crops = pipe.preprocess_batch_device(n["sfd"], n["fan"], frames,
                                                 compute_dtype=align_dtype)[0]
        else:
            crops = st["pool_dev"][:chunk]
        align = pipe.align_for(n["fan"], n["sfd"], compute_dtype=align_dtype)
        run.readings["deca_ms"] = cuda_ms(lambda: deca_m.calculate_shapemodel(
            n["deca"], crops, align_fn=align, compute_dtype=align_dtype))
        pt, at = deca_m.calculate_shapemodel(n["deca"], crops, align_fn=align,
                                             compute_dtype=align_dtype)
        ps = {k: v.expand((chunk,) + tuple(v.shape[1:])) for k, v in params_s.items()}
        shift = dm.direction_matrix_forward(n["a"], geo.make_shift_vector(
            st["spec"], ps, pt, angles_s.expand(chunk, 3), at))
        codes = code.expand((chunk,) + tuple(code.shape[1:]))
        run.readings["synthesis_ms"] = cuda_ms(lambda: pipe.generate_image(
            n["g"], codes, truncation=d["truncation"], truncation_latent=st["trunc"],
            w_plus=True, num_layers_shift=d["num_layers_shift"], shift_code=shift,
            input_is_latent=True, return_latents=True, compute_dtype=dtype))


def _ref_source(run, ref: Dict):
    from reference import reenact
    trunc = reenact.truncation_latent(ref["g"], trunc_rng(run.seed))
    return reenact.source(ref, source_z(run)), trunc, reenact.spec_of(run.cfg)


def _units(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each frame's mean absolute difference, in 8-bit units, of images in
    [-1, 1]."""
    return ((got - want).abs() * 127.5).flatten(1).mean(dim=1)


def _frame_errors(p: torch.Tensor, r: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Each frame's departure of ``p`` from ``r`` (rows are frames) once the
    median departure is taken out, over ``scale``. The source's part of Δp
    is the same in every frame, so what is left is each frame's own DECA →
    Δp → A."""
    diff = (p - r).flatten(1)
    diff = diff - diff.median(dim=0).values
    return diff.norm(dim=1) / scale


def _spread(x: torch.Tensor) -> torch.Tensor:
    """The median frame's distance from the frames' median."""
    x = x.flatten(1)
    return (x - x.median(dim=0).values).norm(dim=1).median()


def check(run, raw: bool) -> Dict[str, float]:
    from reference import plain_float32, reenact
    dev, chunk, d = run.device, run.tr["chunk"], run.cfg["directions"]
    rows, psi = d["num_layers_shift"], d["truncation"]
    ref = nets.reference_nets(run.cfg, NETS, run.seed, dev)
    vals: Dict[str, float] = {}
    shifts_p, shifts_r = [], []

    def worst(name: str, v: float) -> None:
        vals[name] = max(vals.get(name, float("-inf")), float(v))

    with plain_float32(), torch.no_grad():
        src, trunc, spec = _ref_source(run, ref)
        pool = run.readings["pool"]
        for item in run.sample.items:
            j = item["first"]
            if raw:
                frames = pool[j:j + chunk].to(dev)
                _, ok_r, _, pts_r = reenact.preprocess(ref, frames)
                ok_p, pts_p = item["ok"].to(dev), item["landmarks"].to(dev)
                worst("detections_differ", (ok_p != ok_r).sum())
                both = ok_p & ok_r
                dist = (pts_p - pts_r).norm(dim=-1).median(dim=-1).values
                worst("landmarks_px", dist[both].max() if bool(both.any()) else 0.0)
                # the crops the program's DECA read: the reference's crop at
                # the program's landmarks (its 8-bit output is the same crop)
                crops_gan = reenact.crops_from(frames, pts_p)
                worst("crop_units", (reenact.to_u8(crops_gan).int()
                                     - item["crops"].to(dev).int()).abs().max())
            else:
                crops_gan = pool[j:j + chunk].to(dev)
            lat_p = item["latents"].to(dev)
            # the program's shift, read off its latents: the code's rows are
            # one w, so the unshifted rows hold the truncated code alone
            shifts_p.append(lat_p[:, :rows] - lat_p[:, rows:rows + 1])
            shifts_r.append(psi * reenact.shift(ref, spec, src, crops_gan))
            got = item["reenacted"].to(dev)
            img_r = reenact.images(ref["g"], lat_p)
            if got.dtype == torch.uint8:
                got = got.float() / 127.5 - 1.0
                img_r = reenact.to_u8(img_r).float() / 127.5 - 1.0
            worst("image_units", _units(got, img_r).max())
        # each frame's departure in units of how far the frames' shifts lie
        # apart: a DECA, Δp or A that answers a frame wrongly moves it by
        # about that much, rounding by some thousandths of it
        s_r = torch.cat(shifts_r)
        err = _frame_errors(torch.cat(shifts_p), s_r, _spread(s_r))
        run.readings["frame_errors"] = sorted(err.tolist())
        vals["shift_rel"] = float(err.median())
        vals["shift_frames_off"] = float((err > SHIFT_FRAME).sum())
        if run.readings.get("count_flops"):
            frames = pool[:chunk].to(dev) if raw else None

            def one_chunk():
                crops = reenact.preprocess(ref, frames)[0] if raw else pool[:chunk].to(dev)
                shift = reenact.shift(ref, spec, src, crops)
                reenact.images(ref["g"], reenact.latents(src[0], shift, trunc, d["truncation"]))

            run.readings["flops_per_request"] = flops_of(one_chunk)
    del ref
    return vals
