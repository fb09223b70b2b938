"""PyTorch + CUDA port of cobevt_tpu.

The package mirrors the layout of ``cobevt_tpu`` module by module and
never imports JAX.  Parameter names follow the reference's torch attribute
paths, the same paths the flax tree is named after, so
``cobevt_tpu_torch.utils.weights.load_jax_variables`` moves a JAX variable
tree into a port module and ``cobevt_tpu.utils.torch_port.torch_to_flax``
moves it back.  Activations are NHWC, as in the JAX package.
"""
