"""Worked examples of the PyTorch port, each a module with ``main(argv)``.

- ``quickstart``: ray data -> scenario on disk -> channels -> derived
  quantities -> Doppler -> a gradient through the renderer -> a render
  sharded over a device mesh.
- ``serve_channels``: the host render, the device-resident serving loop,
  a dual-polar legacy v3 scenario and codebook beam gains.
- ``learn_beam_codebook``: a BS codebook and the antenna spacing learned
  with autograd through the renderer, then served through the beam-gain
  kernel.
- ``generate_docs_imgs``: the documentation's figures (CPU, matplotlib).

Each runs on ``config['device']``'s CUDA card unless ``--cpu`` is given:
``python -m deepmimo_tpu_torch.examples.quickstart [--cpu]``.
"""
