"""Player texture extraction from DensePose IUV."""

from soccerplayershapepose_torch.texture.uv import (  # noqa: F401
    iuv_to_atlas_texture, fuse_atlas_textures, concat_atlas, split_atlas,
    atlas_to_normal, normal_to_atlas, sample_uv_texture)
