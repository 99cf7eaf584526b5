from .cropping import (crop_from_bbox, crop_using_landmarks, ffhq_crop_box, ffhq_crop_device,
                       landmarks_in_crop)
from .fan import (FAN, ConvBlock, HourGlass, ResNetDepth, conv_block, draw_gaussians,
                  fan_forward, heatmaps_to_landmarks, hourglass, landmarks_to_image_coords,
                  predict_depth, resnet_depth_forward)
from .landmarks import (REFERENCE_SCALE, box_to_center_scale, crop_faces, crop_transform,
                        estimate_landmarks, estimate_landmarks_3d, select_reference_face)
from .s3fd import (S3FD, decode_boxes, dense_anchors, detect_candidates,
                   detect_faces, l2norm_scale, nms_fixed, s3fd_forward)

__all__ = ["crop_from_bbox", "crop_using_landmarks", "ffhq_crop_box", "ffhq_crop_device",
           "landmarks_in_crop", "FAN", "ConvBlock", "HourGlass", "ResNetDepth", "conv_block",
           "draw_gaussians", "fan_forward", "heatmaps_to_landmarks", "hourglass",
           "landmarks_to_image_coords", "predict_depth", "resnet_depth_forward",
           "REFERENCE_SCALE", "box_to_center_scale", "crop_faces", "crop_transform",
           "estimate_landmarks", "estimate_landmarks_3d", "select_reference_face", "S3FD",
           "decode_boxes", "dense_anchors", "detect_candidates", "detect_faces", "l2norm_scale",
           "nms_fixed", "s3fd_forward"]
