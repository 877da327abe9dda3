"""VAE generative model for CbAS/DbAS.

Contract (reference flexs/utils/VAE_utils.py, through the JAX package's
`utils/vae.py`):
  * Architecture (:40-62): encoder Dense(inter, elu) -> Dropout(0.3) ->
    Dense(inter, elu) -> BatchNorm -> Dense(inter, elu) -> (z_mean,
    z_log_var) -> reparameterized z; decoder Dense(inter, elu) ->
    Dense(inter, elu) -> Dropout(0.3) -> Dense(inter, elu) ->
    Dense(original_dim, sigmoid).  The BatchNorm is Flax's (momentum 0.99,
    biased batch variance, eps 1e-5; `baselines.models.torch_model.BatchNorm`).
  * Loss (:74-92): original_dim * mean BCE + KL, the per-sample terms
    weighted by the sample weights (the CbAS paper's weighted MLE; the
    reference's Keras train_step drops them); `clip(0.5)` of every gradient
    entry, then Adam(1e-4) with optax's arithmetic.  The optimizer state
    persists across `train_model` calls.
  * `train_model(samples, weights)` (:132-151): the trailing 20% held out,
    the rest padded by repeating real rows at weight 0 (so that the
    BatchNorm batch statistics stay real) to whole minibatches; per epoch
    a fresh permutation; early stopping on the epoch's mean training loss
    (patience 3).
  * `generate(n, existing)` (:153-187): decode ONE latent draw into a PWM,
    then Boltzmann-sample whole batches, the temperature starting at 0.001
    and growing 1.3x per rejected draw (at most 1.3^20 per batch); the
    latent and the categorical draws come from a seeded numpy Generator in
    the JAX package's order.
  * `calculate_log_probability(seqs, vae)` (:189-217): decode the
    deterministic z_mean (eval mode: running statistics, no dropout), sum
    over positions of log normalized per-residue reconstruction
    probability.

Initialization, dropout, the reparameterization noise and the epoch
permutations draw from a `torch.Generator` seeded from `seed`, an epoch's
draws at once.  On the card a training step is one CUDA graph replay
(`cuda_graph`, the same kernels as the eager step).
"""
from typing import List

import numpy as np
import torch
from torch import nn

from flexs_tpu_torch.alphabet import as_alphabet
from flexs_tpu_torch.baselines.models.torch_model import (
    BatchNorm,
    adam_init,
    adam_step_,
    flat_grad,
    flatten_parameters,
    linear,
)
from flexs_tpu_torch.device import resolve_device
from flexs_tpu_torch.ops.padding import next_bucket

DROPOUT_KEEP = 0.7  # Dropout(0.3)


class VAEModule(nn.Module):
    """Encoder/decoder pair of the reference VAE; weights drawn from `generator`.

    `forward(x)` is the deterministic reconstruction decode(z_mean(x)) in
    eval mode, so `torch.func.functional_call` can run it on a snapshot.
    """

    def __init__(self, original_dim: int, intermediate_dim: int, latent_dim: int,
                 generator: torch.Generator):
        super().__init__()
        g, inter = generator, intermediate_dim
        self.enc1 = linear(original_dim, inter, g)
        self.enc2 = linear(inter, inter, g)
        self.enc_bn = BatchNorm(inter, device=g.device)
        self.enc3 = linear(inter, inter, g)
        self.z_mean_layer = linear(inter, latent_dim, g)
        self.z_log_var_layer = linear(inter, latent_dim, g)

        self.dec1 = linear(latent_dim, inter, g)
        self.dec2 = linear(inter, inter, g)
        self.dec3 = linear(inter, inter, g)
        self.dec_out = linear(inter, original_dim, g)

    def encode(self, x, train: bool = False, keep=None):
        """(z_mean, z_log_var); `keep` (bool, True = kept) is the dropout mask in training."""
        x = nn.functional.elu(self.enc1(x))
        if train:
            x = torch.where(keep, x / DROPOUT_KEEP, 0.0)
        x = nn.functional.elu(self.enc2(x))
        x = self.enc_bn(x, train=train)
        x = nn.functional.elu(self.enc3(x))
        return self.z_mean_layer(x), self.z_log_var_layer(x)

    def decode(self, z, train: bool = False, keep=None):
        x = nn.functional.elu(self.dec1(z))
        x = nn.functional.elu(self.dec2(x))
        if train:
            x = torch.where(keep, x / DROPOUT_KEEP, 0.0)
        x = nn.functional.elu(self.dec3(x))
        return torch.sigmoid(self.dec_out(x))

    def forward(self, x):
        z_mean, _ = self.encode(x)
        return self.decode(z_mean)


def pwm_to_boltzmann_weights(prob_weight_matrix: np.ndarray, temp: float):
    """Column-normalized Boltzmann weights of a PWM at temperature `temp`.

    Matches reference VAE_utils.py:220-233 (softmax of pwm/temp per
    position), computed as one vectorized softmax.
    """
    w = np.asarray(prob_weight_matrix, dtype=np.float64) / temp
    w = w - w.max(axis=0, keepdims=True)
    e = np.exp(w)
    return e / e.sum(axis=0, keepdims=True)


class VAETrainer:
    """A `VAEModule` with its clipped-Adam state and its weighted training step.

    The host `VAE` is one; the fused CbAS runner keeps one per cell.  Its
    weights are drawn from `generator`, on the generator's device.  On the
    card each training step replays one CUDA graph (`cuda_graph`).
    """

    def __init__(self, original_dim: int, intermediate_dim: int, latent_dim: int,
                 batch_size: int, beta: float, generator: torch.Generator):
        self.original_dim = original_dim
        self.intermediate_dim = intermediate_dim
        self.latent_dim = latent_dim
        self.batch_size = batch_size
        self.beta = beta
        self.device = generator.device
        self._generator = generator
        self.module = VAEModule(original_dim, intermediate_dim, latent_dim, generator)
        self._opt_state = adam_init(flatten_parameters(self.module)[None])
        self._loss_sum = torch.zeros((), device=self.device)
        self.cuda_graph = self.device.type == "cuda"
        self._graph = None

    # -- weights (for the CbAS vae_0 snapshot) ------------------------------
    def get_weights(self) -> dict:
        """Snapshot of every weight and statistic (a state dict of copies)."""
        return {k: v.detach().clone() for k, v in self.module.state_dict().items()}

    def set_weights(self, weights: dict):
        """Restore a snapshot taken with `get_weights`."""
        self.module.load_state_dict(weights)

    # -- training -----------------------------------------------------------
    def loss(self, xb, wb, enc_keep, dec_keep, eps):
        """Weighted training loss of one minibatch; moves the BatchNorm statistics."""
        z_mean, z_log_var = self.module.encode(xb, train=True, keep=enc_keep)
        z = z_mean + torch.exp(0.5 * z_log_var) * eps
        recon = self.module.decode(z, train=True, keep=dec_keep)
        tiny = 1e-7
        bce = -(xb * torch.log(recon + tiny) + (1 - xb) * torch.log(1 - recon + tiny)).mean(dim=1)
        denom = torch.sum(wb) + 1e-9
        recon_loss = self.original_dim * torch.sum(bce * wb) / denom
        kl = -0.5 * (1 + z_log_var - torch.square(z_mean) - torch.exp(z_log_var))
        kl_loss = torch.sum(kl.mean(dim=1) * wb) / denom
        return recon_loss + self.beta * kl_loss

    def step(self, xb, wb, enc_keep, dec_keep, eps) -> None:
        """One clipped Adam step on a minibatch, in place; adds its loss to `_loss_sum`."""
        loss = self.loss(xb, wb, enc_keep, dec_keep, eps)
        grads = flat_grad(loss, self.module).clamp(-0.5, 0.5)
        adam_step_(self._opt_state, grads[None], 1e-4)
        self._loss_sum.add_(loss.detach())

    def _training_state(self):
        return (*self._opt_state, *self.module.buffers(), self._loss_sum)

    def _graphed_step(self):
        """(CUDA graph of `step`, its static inputs), captured at first use.

        A step is ~150 small kernels for 10 rows; replaying them as one
        graph removes the host's launch work.  The graph reads its minibatch
        from static buffers and updates the weights, Adam's state and the
        BatchNorm statistics in place, so replays chain like eager steps.
        """
        if self._graph is None:
            dev, bs = self.device, self.batch_size
            static = (
                torch.zeros((bs, self.original_dim), device=dev),
                torch.zeros(bs, device=dev),
                torch.zeros((bs, self.intermediate_dim), dtype=torch.bool, device=dev),
                torch.zeros((bs, self.intermediate_dim), dtype=torch.bool, device=dev),
                torch.zeros((bs, self.latent_dim), device=dev),
            )
            # Warm up on a side stream (library workspaces, Adam's power
            # tables), then undo what the warm-up steps changed.
            saved = [t.clone() for t in self._training_state()]
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(3):
                    self.step(*static)
            torch.cuda.current_stream(dev).wait_stream(side)
            for t, value in zip(self._training_state(), saved):
                t.copy_(value)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.step(*static)
            self._graph = (graph, static)
        return self._graph

    def steps(self, x, w, batches, enc_keep, dec_keep, eps) -> torch.Tensor:
        """Steps on minibatches `x[batches[s]]`, `w[batches[s]]` in order; their loss sum.

        `enc_keep`, `dec_keep` and `eps` hold each step's dropout masks and
        latent noise along their first axis.
        """
        self._loss_sum.zero_()
        if self.cuda_graph:
            graph, (xb, wb, enc, dec, z) = self._graphed_step()
            for s, idx in enumerate(batches):
                torch.index_select(x, 0, idx, out=xb)
                torch.index_select(w, 0, idx, out=wb)
                enc.copy_(enc_keep[s])
                dec.copy_(dec_keep[s])
                z.copy_(eps[s])
                graph.replay()
        else:
            for s, idx in enumerate(batches):
                self.step(x[idx], w[idx], enc_keep[s], dec_keep[s], eps[s])
        return self._loss_sum


class VAE(VAETrainer):
    """VAE wrapper exposing the train/generate/log-prob interface for CbAS."""

    def __init__(
        self,
        seq_length: int,
        alphabet: str,
        batch_size: int = 10,
        latent_dim: int = 2,
        intermediate_dim: int = 250,
        epochs: int = 10,
        epsilon_std: float = 1.0,
        beta: float = 1,
        validation_split: float = 0.2,
        verbose: bool = True,
        seed: int = 0,
        device=None,
    ):
        """Create the VAE on `device` (default "cuda"; pass "cpu" to run on the CPU)."""
        self.epochs = epochs
        self.epsilon_std = epsilon_std
        self.validation_split = validation_split
        self.verbose = verbose
        self.name = f"VAE_latent_dim={latent_dim}_intermediate_dim={intermediate_dim}"

        self.alphabet = as_alphabet(alphabet)
        self.seq_length = seq_length

        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(seed)
        self._rng = np.random.default_rng(seed)
        super().__init__(len(self.alphabet) * seq_length, intermediate_dim, latent_dim,
                         batch_size, beta, generator)

    def _one_hot(self, samples) -> np.ndarray:
        tokens = self.alphabet.encode(list(samples))
        eye = np.eye(len(self.alphabet), dtype=np.float32)
        return eye[tokens].reshape(len(tokens), -1)

    def _epoch(self, x: torch.Tensor, w: torch.Tensor) -> float:
        """One epoch of shuffled full minibatches; the epoch's draws are made at once."""
        g, dev = self._generator, self.device
        bs, inter = self.batch_size, self.intermediate_dim
        num_batches = x.shape[0] // bs
        batches = torch.randperm(x.shape[0], generator=g, device=dev).view(num_batches, bs)
        enc_keep = torch.rand((num_batches, bs, inter), generator=g, device=dev) < DROPOUT_KEEP
        dec_keep = torch.rand((num_batches, bs, inter), generator=g, device=dev) < DROPOUT_KEEP
        eps = torch.randn((num_batches, bs, self.latent_dim), generator=g, device=dev)
        return float(self.steps(x, w, batches, enc_keep, dec_keep, eps) / num_batches)

    def train_model(self, samples, weights):
        """Train on weighted samples with early stopping (patience 3)."""
        x = self._one_hot(samples)
        w = np.asarray(weights, dtype=np.float32)

        # Hold out the trailing validation fraction (keras semantics).
        n_train = max(self.batch_size, int(len(x) * (1 - self.validation_split)))
        n_train = min(n_train, len(x))
        x, w = x[:n_train], w[:n_train]

        bucket = next_bucket(n_train, minimum=self.batch_size)
        bucket = ((bucket + self.batch_size - 1) // self.batch_size) * self.batch_size
        # Pad by REPEATING real rows at weight 0 (not zero rows): padding is
        # shuffled into every minibatch, so all-zero one-hots would pollute
        # the BatchNorm batch statistics and the running averages that
        # calculate_log_probability uses.  Repeats carry real activation
        # statistics and contribute no gradient.
        pad = bucket - n_train
        if pad:
            pidx = np.arange(pad) % n_train
            x = np.concatenate([x, x[pidx]])
            w = np.concatenate([w, np.zeros(pad, np.float32)])
        x = torch.as_tensor(x, device=self.device)
        w = torch.as_tensor(w, device=self.device)

        best_loss, patience = np.inf, 0
        for _ in range(self.epochs):
            loss = self._epoch(x, w)
            if self.verbose:
                print(f"{self.name}: loss {loss:.4f}")
            if loss < best_loss - 1e-12:
                best_loss, patience = loss, 0
            else:
                patience += 1
                if patience >= 3:
                    break

    # -- generation ---------------------------------------------------------
    @torch.no_grad()
    def decode_numpy(self, z: np.ndarray) -> np.ndarray:
        """Eval-mode decoder output f32[n, L * A] of latent points f32[n, latent_dim]."""
        z = torch.as_tensor(np.asarray(z, np.float32), device=self.device)
        return self.module.decode(z).cpu().numpy()

    def generate(
        self, n_samples: int, existing_samples, existing_weights=None
    ) -> List[str]:
        """Generate `n_samples` novel sequences by Boltzmann-sampling a PWM.

        Decodes a single latent normal draw into a PWM, then draws batches
        at escalating temperature until `n_samples` sequences not in
        `existing_samples` are collected.
        """
        z = self._rng.standard_normal((1, self.latent_dim)).astype(np.float32)
        pwm_flat = self.decode_numpy(z)[0]
        pwm = pwm_flat.reshape(self.seq_length, len(self.alphabet)).T  # [A, L]

        if np.isnan(pwm).any() or np.isinf(pwm).any():
            raise ValueError("NaN and/or inf in the reconstruction matrix")

        existing = set(existing_samples)
        proposals: List[str] = []
        seen = set()
        temperature = 0.001
        max_rounds = 200

        for _ in range(max_rounds):
            if len(proposals) >= n_samples:
                break
            weights = pwm_to_boltzmann_weights(pwm, temperature)  # [A, L]
            need = n_samples - len(proposals)
            # One categorical draw per position for a whole batch.
            cum = np.cumsum(weights.T, axis=1)  # [L, A]
            u = self._rng.random((need, self.seq_length, 1))
            tokens = (u > cum[None, :, :]).sum(axis=2).astype(np.int32)
            # cumsum can end at 1 - O(1e-15); a draw in that gap would
            # emit token == len(alphabet) and index out of the alphabet.
            tokens = np.minimum(tokens, len(self.alphabet) - 1)
            batch = self.alphabet.decode(tokens)
            rejections = 0
            for s in batch:
                if s not in existing and s not in seen:
                    seen.add(s)
                    proposals.append(s)
                else:
                    rejections += 1
            # The reference escalates 1.3x per rejected draw, one draw at a
            # time; a whole batch drawn at one temperature can reject nearly
            # everything at once, so the per-batch exponent is capped
            # (batched escalation, bounded per batch, unbounded overall).
            if rejections:
                temperature *= 1.3 ** min(rejections, 20)

        if len(proposals) < n_samples:
            raise RuntimeError(
                f"VAE.generate could not find {n_samples} novel sequences"
            )
        return proposals[:n_samples]

    # -- scoring ------------------------------------------------------------
    @torch.no_grad()
    def reconstruct(self, x: np.ndarray, vae=None) -> np.ndarray:
        """decode(z_mean(encode(x))) f32[n, L * A] in eval mode, under `vae` or the current weights."""
        x = torch.as_tensor(x, device=self.device)
        if vae is None:
            return self.module(x).cpu().numpy()
        return torch.func.functional_call(self.module, vae, (x,)).cpu().numpy()

    def calculate_log_probability(self, sequences, vae=None) -> np.ndarray:
        """Log probability of reconstructing each sequence.

        `vae` may be a snapshot from `get_weights` (the CbAS vae_0) or None
        for the current weights.

        Documented deviation: reconstruction decodes the DETERMINISTIC
        z_mean, where the reference's `vae.predict` routes through the
        stochastic Sampling layer (one z ~ N(z_mean, z_sd) per call).  The
        deterministic form makes CbAS importance weights reproducible; it
        is the mode of the reference's noisy estimate.
        """
        x = self._one_hot(sequences)
        n = len(x)
        decoded = self.reconstruct(x, vae)
        decoded = decoded.reshape(n, self.seq_length, len(self.alphabet))
        one_hots = x.reshape(n, self.seq_length, len(self.alphabet))

        per_res_probs = (decoded * one_hots).max(axis=2) / decoded.sum(axis=2)
        log_probs = np.log(1e-9 + per_res_probs).sum(axis=1)
        return np.nan_to_num(log_probs)
