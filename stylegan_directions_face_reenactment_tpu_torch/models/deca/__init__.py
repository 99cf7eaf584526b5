from .deca import (DECA, DetailGenerator, ResnetEncoder, calculate_shape,
                   calculate_shapemodel, decompose_code, deca_decode, deca_encode,
                   detail_generator_forward, extract_deca_params, resnet_encoder_forward)
from .flame import FLAME, FLAMETex, flame_forward, flametex_forward, synthetic_flame_params
from .mesh_io import (load_dense_template, save_obj, save_ply, upsample_mesh, visualize,
                      write_obj)
from .render import (add_directionlight, decode_deca, face_vertices, rasterize,
                     render_shape, shape_visualization, vertex_normals)
from .resnet import ResNet50, resnet50_features

__all__ = ["DECA", "DetailGenerator", "FLAME", "FLAMETex", "ResnetEncoder", "ResNet50",
           "add_directionlight", "calculate_shape", "calculate_shapemodel",
           "decode_deca", "decompose_code", "deca_decode", "deca_encode",
           "detail_generator_forward", "extract_deca_params", "face_vertices",
           "flame_forward", "flametex_forward", "load_dense_template", "rasterize",
           "render_shape", "resnet_encoder_forward", "resnet50_features", "save_obj",
           "save_ply", "shape_visualization", "synthetic_flame_params", "upsample_mesh",
           "vertex_normals", "visualize", "write_obj"]
