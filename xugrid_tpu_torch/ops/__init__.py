from xugrid_tpu_torch.ops.earcut import earcut_triangulate

__all__ = ["earcut_triangulate"]
