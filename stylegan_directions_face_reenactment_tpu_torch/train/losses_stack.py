"""The training loss stack: shape, eye and mouth losses through FLAME, the
identity loss, LPIPS, and for the paired method the pixel loss and the
optional W+ regulariser (the reference's ``utils_train.py:376-499``; the
JAX package's ``train/losses_stack.py``). As there:

* the camera is [8, 0, 0] for both coefficient sets before the FLAME
  decode, so the landmarks are comparable whatever the pose (``:392-394,
  405-406``);
* the paired path gives LPIPS and the pixel loss images in [0, 255]
  (``:438-439,483``), the unpaired one in [-1, 1];
* the comparison targets are detached, as the reference's ``.detach()``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..geometry.directions import DirectionsSpec, get_params_gt_reenacted
from ..losses.id_loss import id_loss
from ..losses.lpips import LPIPS, lpips
from ..losses.shape_losses import eye_loss, mouth_loss, pixel_wise_loss, shape_loss
from ..models.deca.deca import DECA, calculate_shape
from ..models.irse import Backbone
from ..utils.image_utils import torch_range_1_to_255

Coeffs = Dict[str, torch.Tensor]


def _fixed_cam(batch: int, device) -> torch.Tensor:
    return torch.tensor([[8.0, 0.0, 0.0]], device=device).repeat(batch, 1)


def _shape_losses(deca: DECA, coeff_gt: Coeffs, coeff_reen: Coeffs,
                  lambdas: Dict[str, float]) -> Tuple[torch.Tensor, ...]:
    lm2d_gt, _, shape_gt = calculate_shape(deca, coeff_gt)
    lm2d_re, _, shape_re = calculate_shape(deca, coeff_reen)
    return (lambdas["lambda_shape"] * shape_loss(shape_gt, shape_re),
            lambdas["lambda_mouth_shape"] * mouth_loss(lm2d_gt, lm2d_re),
            lambdas["lambda_eye_shape"] * eye_loss(lm2d_gt, lm2d_re))


def _add_shape_terms(loss_dict, deca, gt_pose, gt_exp, gt_shape, params_shifted, lambdas):
    b = params_shifted["pose"].shape[0]
    cam = _fixed_cam(b, gt_pose.device)
    coeff_gt = {"pose": gt_pose.detach(), "exp": gt_exp.detach(), "cam": cam,
                "shape": gt_shape.detach()}
    coeff_reen = {"pose": params_shifted["pose"], "shape": params_shifted["alpha_shp"],
                  "exp": params_shifted["alpha_exp"], "cam": cam}
    l_shape, l_mouth, l_eye = _shape_losses(deca, coeff_gt, coeff_reen, lambdas)
    loss_dict["loss_shape"] = l_shape
    loss_dict["loss_eye"] = l_eye
    loss_dict["loss_mouth"] = l_mouth
    return l_shape + l_mouth + l_eye


def calculate_losses(deca: DECA, id_backbone: Backbone, lp: LPIPS, spec: DirectionsSpec,
                     lambdas: Dict[str, float], params_source: Coeffs,
                     angles_source: torch.Tensor, params_shifted: Coeffs,
                     params_target: Coeffs, shift_vector: torch.Tensor,
                     target_indices: torch.Tensor, imgs_source: torch.Tensor,
                     imgs_shifted: torch.Tensor, *, disentanglement_50: bool = True
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The unpaired loss (``utils_train.py:376-433``): (total, terms)."""
    loss_dict: Dict[str, torch.Tensor] = {}
    total = 0.0
    if lambdas["lambda_shape"] > 0:
        if disentanglement_50:
            gt = get_params_gt_reenacted(spec, params_source, params_target, shift_vector,
                                         target_indices, angles_source)
            gt_pose, gt_exp = gt["pose"], gt["exp"]
        else:
            gt_pose, gt_exp = params_target["pose"], params_target["alpha_exp"]
        total = total + _add_shape_terms(loss_dict, deca, gt_pose, gt_exp,
                                         params_source["alpha_shp"], params_shifted, lambdas)
    if lambdas["lambda_identity"] != 0:
        l_id = lambdas["lambda_identity"] * id_loss(id_backbone, imgs_shifted,
                                                    imgs_source.detach())
        loss_dict["loss_identity"] = l_id
        total = total + l_id
    if lambdas["lambda_perceptual"] != 0:
        l_lp = lambdas["lambda_perceptual"] * lpips(lp, imgs_shifted, imgs_source.detach())
        loss_dict["loss_perceptual"] = l_lp
        total = total + l_lp
    loss_dict["loss"] = total
    return total, loss_dict


def calculate_losses_paired(deca: DECA, id_backbone: Backbone, lp: LPIPS,
                            lambdas: Dict[str, float], params_shifted: Coeffs,
                            params_target: Coeffs, imgs_shifted: torch.Tensor,
                            imgs_target: torch.Tensor,
                            shifted_latents: Optional[torch.Tensor] = None,
                            target_w: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The paired loss against the real target frame
    (``utils_train.py:435-499``): (total, terms)."""
    loss_dict: Dict[str, torch.Tensor] = {}
    total = 0.0
    shifted_255 = torch_range_1_to_255(imgs_shifted)
    target_255 = torch_range_1_to_255(imgs_target).detach()
    if lambdas["lambda_shape"] > 0:
        total = total + _add_shape_terms(loss_dict, deca, params_target["pose"],
                                         params_target["alpha_exp"],
                                         params_target["alpha_shp"], params_shifted, lambdas)
    if lambdas["lambda_identity"] != 0:
        l_id = lambdas["lambda_identity"] * id_loss(id_backbone, imgs_shifted,
                                                    imgs_target.detach())
        loss_dict["loss_identity"] = l_id
        total = total + l_id
    if lambdas["lambda_perceptual"] != 0:
        l_lp = lambdas["lambda_perceptual"] * lpips(lp, shifted_255, target_255)
        loss_dict["loss_perceptual"] = l_lp
        total = total + l_lp
    if lambdas["lambda_pixel_wise"] != 0:
        l_px = lambdas["lambda_pixel_wise"] * pixel_wise_loss(shifted_255, target_255)
        loss_dict["loss_pixel_wise"] = l_px
        total = total + l_px
    if lambdas.get("lambda_w_reg", 0.0) != 0 and shifted_latents is not None:
        l_w = lambdas["lambda_w_reg"] * torch.mean(torch.abs(shifted_latents - target_w))
        loss_dict["loss_w_reg"] = l_w
        total = total + l_w
    loss_dict["loss"] = total
    return total, loss_dict
