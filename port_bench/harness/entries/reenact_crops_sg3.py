"""FFHQ-aligned crops in, faces reenacted by StyleGAN3-T out: the same
closed loop as ``reenact_crops.py`` (``make_reenact_fn``, DECA aligned by
SFD + FAN on the crop, Δp → A, synthesis; float32 crops in host memory, the
outputs copied back), with the configuration's StyleGAN3-T generator in
StyleGAN2's place (``harness/nets_sg3.py``). The source identity is a
seeded z → mapping → W+ → synthesis → DECA, and the check follows the
program's outputs and latents against the reference's StyleGAN3, a frame at
a time (``reference/reenact_sg3.py``). The control runs the program's own
bf16 path."""

from __future__ import annotations

import importlib
from typing import Dict

import torch

from .. import common, nets, nets_sg3, traffic
from . import reenact_common as rc
from . import reenact_crops as crops

FACE_NETS = ("a", "deca", "sfd", "fan")
OPS = ("sdfr::fused_conv_block", "sdfr::filtered_lrelu")
window, release = crops.window, crops.release


def port_source(run, n: Dict):
    sg3 = importlib.import_module(f"{common.PORT}.models.stylegan3")
    pipe = importlib.import_module(f"{common.PORT}.pipeline")
    geo = importlib.import_module(f"{common.PORT}.geometry")
    d = run.cfg["directions"]
    spec = geo.initialize_directions(d["dataset"], d["learned_directions"], d["shift_scale"])
    with torch.inference_mode():
        trunc = sg3.mean_latent(n["g"], rc.trunc_rng(run.seed), 4096)
        code = sg3.style_to_wplus(n["g"], [sg3.mapping(n["g"], rc.source_z(run))])
        params, angles = pipe.source_shape(n["deca"], sg3.synthesis(n["g"], code),
                                           n["fan"], n["sfd"])
    return (code, params, angles), trunc, spec


def setup(run) -> None:
    tr, dev = run.tr, run.device
    port = importlib.import_module(f"{common.PORT}.pipeline")
    n = nets.port_nets(common.PORT, run.cfg, FACE_NETS, run.seed, dev)
    n["g"] = nets_sg3.port_g(common.PORT, run.cfg, run.seed, dev)
    run.state["nets"] = n
    src, trunc, spec = port_source(run, n)
    dtype = torch.bfloat16 if run.control else torch.float32
    fn = port.make_reenact_fn(
        n["g"], n["a"], n["deca"], spec, truncation=run.cfg["directions"]["truncation"],
        truncation_latent=trunc, num_layers_shift=run.cfg["directions"]["num_layers_shift"],
        compute_dtype=dtype, fan_params=n["fan"], s3fd_params=n["sfd"], device=dev)
    if run.fault is not None:
        fn = run.fault(fn)
    pool = traffic.crops(tr, run.seed, tr["pool_frames"], dev).cpu()
    pool_np = pool.numpy()
    chunk = tr["chunk"]
    host_out = []

    def step(i: int):
        j = (i * chunk) % pool_np.shape[0]
        reen, lat = fn(*src, pool_np[j:j + chunk])
        host_out[:] = [reen.cpu(), lat.cpu()]
        return j

    run.state.update(src=src, trunc=trunc, spec=spec, fn=fn, step=step, host_out=host_out,
                     pool_dev=pool[:chunk].to(dev))
    run.readings["pool"] = pool
    for i in range(tr["warm_chunks"]):
        step(i)


def traced(run) -> None:
    crops.traced(run)
    run.readings["ops"] = OPS


def check(run) -> Dict[str, float]:
    from reference import plain_float32, reenact, reenact_sg3
    dev, chunk, d = run.device, run.tr["chunk"], run.cfg["directions"]
    rows, psi = d["num_layers_shift"], d["truncation"]
    ref = nets.reference_nets(run.cfg, FACE_NETS, run.seed, dev)
    ref["g"] = nets_sg3.reference_g(run.cfg, run.seed, dev)
    vals: Dict[str, float] = {}
    shifts_p, shifts_r = [], []
    with plain_float32(), torch.no_grad():
        trunc = reenact_sg3.truncation_latent(ref["g"], rc.trunc_rng(run.seed))
        src = reenact_sg3.source(ref, rc.source_z(run))
        spec = reenact.spec_of(run.cfg)
        pool = run.readings["pool"]
        for item in run.sample.items:
            j = item["first"]
            crops_gan = pool[j:j + chunk].to(dev)
            lat_p = item["latents"].to(dev)
            # the program's shift, read off its latents: the code's rows are
            # one w, so the unshifted rows hold the truncated code alone
            shifts_p.append(lat_p[:, :rows] - lat_p[:, rows:rows + 1])
            shifts_r.append(psi * reenact.shift(ref, spec, src, crops_gan))
            img_r = reenact_sg3.images(ref["g"], lat_p)
            got = item["reenacted"].to(dev).float()
            units = rc._units(got, img_r).max()
            vals["image_units"] = max(vals.get("image_units", float("-inf")), float(units))
            # each frame's worst pixel over its largest: a fault in a few of
            # K4's tiles or at a plane's edge moves few pixels, which the
            # frame's mean hides; rounding moves pixels in proportion to
            # their size
            rel = ((got - img_r).abs().flatten(1).max(dim=1).values
                   / img_r.abs().flatten(1).max(dim=1).values).max()
            vals["image_max_rel"] = max(vals.get("image_max_rel", float("-inf")), float(rel))
        s_r = torch.cat(shifts_r)
        err = rc._frame_errors(torch.cat(shifts_p), s_r, rc._spread(s_r))
        run.readings["frame_errors"] = sorted(err.tolist())
        vals["shift_rel"] = float(err.median())
        vals["shift_frames_off"] = float((err > rc.SHIFT_FRAME).sum())
        if run.readings.get("count_flops"):
            def one_chunk():
                shift = reenact.shift(ref, spec, src, pool[:chunk].to(dev))
                reenact_sg3.images(ref["g"], reenact.latents(src[0], shift, trunc, psi))

            run.readings["flops_per_request"] = reenact_sg3.count_flops(one_chunk)
    del ref
    return vals
