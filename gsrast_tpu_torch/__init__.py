"""gsrast_tpu_torch: the 3D Gaussian splatting renderer of `gsrast_tpu` in
PyTorch, with its TPU kernels rewritten by hand in CUDA C++ for NVIDIA
Hopper. It imports neither JAX nor `gsrast_tpu`; the CUDA kernels build at
first use (see `_kernels.py`)."""

from .camera import Camera, auto_frame, look_at, make_camera, perspective
from .config import RenderConfig
from .render.api import auto_render_config, default_render_config, render
from .scene.gaussians import GaussianScene, from_numpy, random_scene
from .scene.ply import load_ply

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "GaussianScene",
    "RenderConfig",
    "auto_frame",
    "auto_render_config",
    "default_render_config",
    "from_numpy",
    "load_ply",
    "look_at",
    "make_camera",
    "perspective",
    "random_scene",
    "render",
]
