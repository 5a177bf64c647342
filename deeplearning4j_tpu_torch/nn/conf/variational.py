"""The variational autoencoder layer: counterpart of
``deeplearning4j_tpu/nn/conf/variational.py`` (the reference's
``VariationalAutoencoder``).

- The supervised forward (``apply``) emits the mean of q(z|x): inside a
  larger net the pretrained layer is a deterministic encoder.
- Unsupervised pretraining (``MultiLayerNetwork.pretrain``) minimizes the
  negative ELBO, −E_q[log p(x|z)] + KL(q‖p), by the reparameterization
  trick over ``num_samples`` samples batched on a leading axis.
- Reconstruction distributions: Gaussian with a learned log-variance, or
  Bernoulli over logits.
- Params as the reference names them: ``e{i}W/e{i}b`` (encoder),
  ``pZXMeanW/b``, ``pZXLogStd2W/b`` (posterior), ``d{i}W/d{i}b``
  (decoder), ``pXZW/b`` (reconstruction head).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn import activations as _act
from deeplearning4j_tpu_torch.nn import weights as _winit
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Layer, register_layer
from deeplearning4j_tpu_torch.ops.standard import promote_mm


def _flat(x):
    return x.reshape(x.shape[0], -1) if x.dim() > 2 else x


@register_layer
@dataclasses.dataclass
class VariationalAutoencoder(Layer):
    n_in: Optional[int] = None
    n_out: Optional[int] = None                      # latent size
    encoder_layer_sizes: Tuple[int, ...] = (100,)
    decoder_layer_sizes: Tuple[int, ...] = (100,)
    reconstruction_distribution: str = "gaussian"    # or "bernoulli"
    pzx_activation: str = "identity"                 # on the posterior stats
    num_samples: int = 1

    def __post_init__(self):
        self.encoder_layer_sizes = tuple(self.encoder_layer_sizes)
        self.decoder_layer_sizes = tuple(self.decoder_layer_sizes)

    # ------------------------------------------------------------ shape/info
    def set_n_in(self, input_type: InputType):
        if self.n_in is None:
            self.n_in = input_type.array_elements()

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    def is_pretrain_layer(self) -> bool:
        return True

    def _recon_params_size(self) -> int:
        if self.reconstruction_distribution == "gaussian":
            return 2 * self.n_in      # mean and log-variance a unit
        if self.reconstruction_distribution == "bernoulli":
            return self.n_in          # logits
        raise ValueError(self.reconstruction_distribution)

    def param_shapes(self) -> Dict[str, tuple]:
        shapes = {}
        prev = self.n_in
        for i, sz in enumerate(self.encoder_layer_sizes):
            shapes[f"e{i}W"] = (prev, sz)
            shapes[f"e{i}b"] = (sz,)
            prev = sz
        shapes["pZXMeanW"] = (prev, self.n_out)
        shapes["pZXMeanb"] = (self.n_out,)
        shapes["pZXLogStd2W"] = (prev, self.n_out)
        shapes["pZXLogStd2b"] = (self.n_out,)
        prev = self.n_out
        for i, sz in enumerate(self.decoder_layer_sizes):
            shapes[f"d{i}W"] = (prev, sz)
            shapes[f"d{i}b"] = (sz,)
            prev = sz
        shapes["pXZW"] = (prev, self._recon_params_size())
        shapes["pXZb"] = (self._recon_params_size(),)
        return shapes

    def init_params(self, gen):
        p = {}
        for name, shape in self.param_shapes().items():
            if name.endswith("b"):
                p[name] = torch.full(shape, float(self.bias_init))
            else:
                p[name] = _winit.init(self.weight_init, gen, shape, shape[0],
                                      shape[1])
        return p

    # ------------------------------------------------------------- internals
    def _encode(self, params, x):
        act = _act.get(self.activation or "identity")
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(promote_mm(h, params[f"e{i}W"]) + params[f"e{i}b"])
        pzx = _act.get(self.pzx_activation)
        mean = pzx(promote_mm(h, params["pZXMeanW"]) + params["pZXMeanb"])
        log_var = pzx(promote_mm(h, params["pZXLogStd2W"])
                      + params["pZXLogStd2b"])
        return mean, log_var

    def _decode(self, params, z):
        act = _act.get(self.activation or "identity")
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(promote_mm(h, params[f"d{i}W"]) + params[f"d{i}b"])
        return promote_mm(h, params["pXZW"]) + params["pXZb"]

    def _recon_neg_log_prob(self, dist_params, x):
        """−log p(x|z) summed over the features, an example each."""
        if self.reconstruction_distribution == "gaussian":
            mean, log_var = torch.chunk(dist_params, 2, dim=-1)
            log_var = torch.clamp(log_var, -10.0, 10.0)
            return 0.5 * torch.sum(log_var + math.log(2 * math.pi)
                                   + torch.square(x - mean)
                                   / torch.exp(log_var), dim=-1)
        logits = dist_params           # Bernoulli: BCE with logits, stably
        return torch.sum(torch.maximum(logits, torch.zeros_like(logits))
                         - logits * x + torch.log1p(torch.exp(-torch.abs(
                             logits))), dim=-1)

    # ------------------------------------------------------------- execution
    def apply(self, params, x, training=False, gen=None, state=None):
        x = self._maybe_dropout(_flat(x), training, gen)
        mean, _ = self._encode(params, x)
        return mean, state

    def pretrain_loss(self, params, x, gen=None, eps=None):
        """The negative ELBO, mean over the batch (the reference's
        ``computeGradientAndScore`` in pretrain mode). ``eps`` is the
        reparameterization's (num_samples, N, latent) standard normal draw;
        without it one is drawn from ``gen``."""
        x = _flat(x)
        mean, log_var = self._encode(params, x)
        kl = -0.5 * torch.sum(1.0 + log_var - torch.square(mean)
                              - torch.exp(log_var), dim=-1)
        if eps is None:
            eps = torch.randn((self.num_samples,) + tuple(mean.shape),
                              generator=gen, device=mean.device,
                              dtype=mean.dtype)
        z = mean[None] + torch.exp(0.5 * log_var)[None] * eps   # (S, N, L)
        dist = self._decode(params, z.reshape(-1, self.n_out))
        nll = self._recon_neg_log_prob(dist, x.repeat(self.num_samples, 1))
        nll = nll.reshape(self.num_samples, -1).mean(dim=0)
        return torch.mean(nll + kl)

    # ---------------------------------------------------- reference surface
    def _mean_of(self, dist):
        if self.reconstruction_distribution == "gaussian":
            return torch.chunk(dist, 2, dim=-1)[0]
        return torch.sigmoid(dist)

    def reconstruct(self, params, x, gen=None):
        """x → the decoder's output at the posterior mean."""
        mean, _ = self._encode(params, _flat(x))
        return self._mean_of(self._decode(params, mean))

    def generate_at_mean_given_z(self, params, z):
        """Latent → the reconstruction mean."""
        return self._mean_of(self._decode(params, z))

    def reconstruction_error(self, params, x):
        """Per-example −log p(x|z = mean)."""
        x = _flat(x)
        mean, _ = self._encode(params, x)
        return self._recon_neg_log_prob(self._decode(params, mean), x)
