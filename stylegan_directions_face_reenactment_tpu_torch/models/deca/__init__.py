from .deca import (DECA, IMAGE_SIZE, N_PARAM, PARAM_SPLIT, DetailGenerator, ResnetEncoder,
                   calculate_shape, calculate_shapemodel, decompose_code, deca_decode,
                   deca_encode, detail_generator_forward, extract_deca_params,
                   resnet_encoder_forward)
from .flame import (FLAME, FLAMETex, batch_rigid_transform, blend_shapes,
                    find_dynamic_lmk_idx, flame_forward, flametex_forward, lbs, select_3d68,
                    synthetic_flame_params, vertices2joints, vertices2landmarks)
from .mesh_io import (load_dense_template, save_obj, save_ply, upsample_mesh, visualize,
                      write_obj)
from .render import (add_directionlight, decode_deca, face_vertices, rasterize,
                     render_shape, shape_visualization, vertex_normals)
from .resnet import ResNet50, resnet50_features

__all__ = ["DECA", "DetailGenerator", "FLAME", "FLAMETex", "IMAGE_SIZE", "N_PARAM",
           "PARAM_SPLIT", "ResnetEncoder", "ResNet50", "add_directionlight",
           "batch_rigid_transform", "blend_shapes", "calculate_shape", "calculate_shapemodel",
           "decode_deca", "decompose_code", "deca_decode", "deca_encode",
           "detail_generator_forward", "extract_deca_params", "face_vertices",
           "find_dynamic_lmk_idx", "flame_forward", "flametex_forward", "lbs",
           "load_dense_template", "rasterize", "render_shape", "resnet_encoder_forward",
           "resnet50_features", "save_obj", "save_ply", "select_3d68", "shape_visualization",
           "synthetic_flame_params", "upsample_mesh", "vertex_normals", "vertices2joints",
           "vertices2landmarks", "visualize", "write_obj"]
