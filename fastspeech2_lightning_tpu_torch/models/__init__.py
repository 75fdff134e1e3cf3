"""The serving path's models: FastSpeech2 (inference forward) and the HiFiGAN
generator."""
