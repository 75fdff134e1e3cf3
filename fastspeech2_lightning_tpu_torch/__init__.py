"""fastspeech2_lightning_tpu_torch — the PyTorch/CUDA port.

Serving (text -> FastSpeech2 mel -> HiFiGAN wav over HTTP, batched or
streamed window by window), the ``synthesize`` command, acoustic and
vocoder training, and the corpus front end (``preprocess``, ``check-data``,
``convert-artifacts``), on an NVIDIA Hopper card, for character, phone and
phonological-feature models with speakers, languages and global style
tokens. Plain tensor code is PyTorch; the kernels (attention forward and
backward, MAS, the CTC scans and the HiFiGAN multi-receptive-field stage)
are CUDA C++ under ``csrc/``, built with nvcc on first use
(``kernels/build.py``).

The package imports neither JAX nor the JAX package beside it: what it needs
of that package's host-side modules (config, text, synthesis preparation) it
keeps as its own copies. Weights arrive as Lightning ``.ckpt`` files in the
reference state_dict layout (``fs2t export-checkpoint`` writes them from an
orbax checkpoint) and HiFiGAN ``.npz``/``.ckpt`` files.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
