from distantspeech_tpu_torch.postfilter.mccowan import McCowanConfig, mccowan_gain, mccowan_process

__all__ = ["McCowanConfig", "mccowan_gain", "mccowan_process"]
