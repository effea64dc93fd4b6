"""The VAE's training losses of the port: LPIPS (``lpips.py``) and the
KL, discriminator and perceptual losses (``vae_losses.py``).

Counterpart of ``panacea_tpu/losses``. Keys are the reference lpips and
PatchGAN modules' names.
"""
