#!/usr/bin/env python3
"""Time the PyTorch port's slice 2 bf16 request and a PTI step, for
comparing two trees of the repository on one card.

    python3 tools/torch_dispatch_timing.py [TREE]

``TREE`` (default: this repository) is a checkout whose
``stylegan_directions_face_reenactment_tpu_torch`` package is imported,
so that a parent commit unpacked with ``git archive`` and the working
tree can be run in turns (parent, change, change, parent) on one card, each
in its own process. Each tree builds its own kernels. Needs a CUDA card;
imports nothing of JAX.

It prints one JSON line: the card's name and power limit, the median,
min and max ms of a request of 16 raw 562x1000 uint8 frames through
``make_fused_reenact_fn`` in bf16 (S3FD, FAN, the FFHQ crop, DECA aligned
by SFD + FAN, synthesis; ``outputs="reenact"``; the seeded nets of
``chip_smoke.py``'s slice 2), each request synchronized, and the median,
min and max ms of a PTI step (``optimize_g``, 100·MSE + LPIPS over
``convs[4..11]``) from runs of 20 steps. TF32 is off.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REQUESTS, WARM = 30, 5            # timed and warm-up requests
PTI_RUNS, PTI_STEPS = 5, 20


def main(tree):
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_dispatch_timing: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from stylegan_directions_face_reenactment_tpu_torch.geometry import initialize_directions
    from stylegan_directions_face_reenactment_tpu_torch.models.stylegan2 import (
        mapping, mean_latent, style_to_wplus, synthesis)
    from stylegan_directions_face_reenactment_tpu_torch.pipeline import (
        make_fused_reenact_fn, optimize_g, source_shape)
    from stylegan_directions_face_reenactment_tpu_torch.weights import (
        init_deca, init_direction_matrix, init_fan, init_generator, init_lpips, init_s3fd)
    import stylegan_directions_face_reenactment_tpu_torch as pkg
    assert os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) == \
        os.path.abspath(tree), pkg.__file__

    g = init_generator(0, 256, 512, 8, 1)
    a = init_direction_matrix(1, 512, 15, w_plus=True, num_layers=8)
    deca, sfd, fan = init_deca(2), init_s3fd(5), init_fan(6, 4)
    spec = initialize_directions("voxceleb", 15, 6.0)
    with torch.inference_mode():
        trunc = mean_latent(g, torch.Generator().manual_seed(3), 4096)
        z = torch.randn(1, 512, generator=torch.Generator().manual_seed(4)).cuda()
        code = style_to_wplus(g, [mapping(g, z)])
        src_img = synthesis(g, code)
        ps, ang = source_shape(deca, src_img, fan, sfd)
    frames = torch.randint(0, 256, (16, 562, 1000, 3), generator=torch.Generator().manual_seed(20),
                           dtype=torch.uint8).cuda()
    fn = make_fused_reenact_fn(g, a, deca, spec, sfd, fan, truncation_latent=trunc,
                               compute_dtype=torch.bfloat16, fan_params=fan, s3fd_params=sfd,
                               outputs="reenact")
    times = []
    for i in range(WARM + REQUESTS):
        t0 = time.perf_counter()
        fn(code, ps, ang, frames)
        torch.cuda.synchronize()
        if i >= WARM:
            times.append((time.perf_counter() - t0) * 1e3)
    lp = init_lpips(8)
    optimize_g(g, code, src_img, lp, trunc, opt_steps=2)
    steps = []
    for _ in range(PTI_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        optimize_g(g, code, src_img, lp, trunc, opt_steps=PTI_STEPS)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3 / PTI_STEPS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "tree": os.path.abspath(tree), "card": smi.strip().splitlines()[0],
        "slice2_bf16_request_ms": statistics.median(times),
        "slice2_bf16_request_ms_range": [min(times), max(times)],
        "pti_step_ms": statistics.median(steps), "pti_step_ms_range": [min(steps), max(steps)]}))


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else
         os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
