"""The tiny SD v2 / v2_v model of the port's SD v2 parity tests, on both
sides: v2's options (linear `proj_in` / `proj_out`, heads from
`num_head_channels`: 8 channels a head, so 4 and 8 heads at the two
widths; a 32-wide context from a three-layer CLIP text tower with
`quick_gelu`; the v-parameterization) on 8x8 latents of a 64px first
stage, 50 timesteps on SD's schedule; the zero-initialised kernels of the
JAX model redrawn, its weights carried to the port by the strict bridge."""

from flax import nnx

import cflearn_torch
from _torch_bridge_common import bridged, dezero
from cflearn_torch.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel as TCLIPText
from cflearn_tpu.modules.multimodal.diffusion import ldm as JL
from cflearn_tpu.modules.multimodal.diffusion.cond_models import CLIPTextConditionModel

T = 50
UNET = dict(
    start_channels=32, num_res_blocks=1, channel_multipliers=(1, 2), attention_downsample_rates=(1, 2),
    num_head_channels=8, num_heads=None, context_dim=32, use_linear_in_transformer=True,
)
FIRST_STAGE = dict(
    img_size=64, inner_channels=32, z_channels=4, embedding_channels=4, channel_multipliers=[1, 2, 2, 2],
    num_res_blocks=1,
)
CLIP = dict(latent_dim=32, num_layers=3, num_heads=2)
SD_SCHEDULE = dict(linear_start=0.00085, linear_end=0.012)


def v_pair():
    """The JAX v-model and the port's, bridged (f32, CPU)."""
    kw = dict(img_size=8, in_channels=4, out_channels=4, num_timesteps=T, parameterization="v", unet_config=UNET,
              first_stage_config=FIRST_STAGE, **SD_SCHEDULE)
    jm = JL.LDM(condition_model=CLIPTextConditionModel(rngs=nnx.Rngs(1), **CLIP), rngs=nnx.Rngs(0), **kw)
    dezero(jm, seed=3)
    tm = cflearn_torch.build(cflearn_torch.LDM, device="cpu", condition_model=TCLIPText(**CLIP), **kw)
    return jm, bridged(jm, tm)
