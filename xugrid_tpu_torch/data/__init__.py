from xugrid_tpu_torch.data.synthetic import (
    adh_san_diego,
    disk,
    elevation_nl,
    generate_disk,
    hydamo_network,
    provinces_nl,
    xoxo,
)

__all__ = [
    "adh_san_diego",
    "disk",
    "elevation_nl",
    "generate_disk",
    "hydamo_network",
    "provinces_nl",
    "xoxo",
]
