from .imgproc import extract_frames, from_gan_range, generate_video, resize_bilinear_u8, video_fps

__all__ = ["extract_frames", "from_gan_range", "generate_video", "resize_bilinear_u8",
           "video_fps"]
