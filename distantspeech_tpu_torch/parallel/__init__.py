from distantspeech_tpu_torch.parallel.mesh import batch_sharding, make_mesh
from distantspeech_tpu_torch.parallel.sharded import (
    enhance_process_sharded,
    make_sharded_enhance,
    make_sharded_enhance_mega,
    make_sharded_enhance_pallas,
    make_sharded_gsc,
    make_sharded_subband_gsc,
    make_sharded_tdgsc_fused,
    make_sharded_wpe,
)
