from distantspeech_tpu_torch.runtime.io import find_files, load_audio, load_pcm, load_wav_dir, pcmread, save_audio
from distantspeech_tpu_torch.runtime.streaming import StreamingProcessor
