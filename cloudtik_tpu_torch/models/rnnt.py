"""RNN-T speech recognizer in PyTorch (LSTM encoder/predictor + joint).

Counterpart of `cloudtik_tpu/models/rnnt.py`: the same `RNNTConfig`,
presets and `flops_per_frame`, and the same parameter tree (`encoder` and
`predictor.layers` as lists of `{w [d_in + H, 4H], b [4H]}`, the joint's
projections), so `convert.params_from_jax` is a plain copy.  The lattice
loss is `ops.transducer.transducer_loss`.

The LSTM layer is the reference's, step for step: one fused `[x, h] @ w`
per time step in the compute dtype, `h` cast to it before the product,
the gates and the cell state `c` in f32, the gate order i, f, g, o, and a
forget-gate bias of 1.0 at init.  `torch.nn.LSTM` (cuDNN) would keep `c`
in the compute dtype and split the product, which computes something
else, so the port loops over time in Python as `lax.scan` does.

`greedy_decode` seeds the decode with the start-of-sequence step pushed
through the predictor stack, emits at most one symbol a frame, and pads
its output with 0 past `max_symbols`, as the reference does.

On a mesh (`param_logical_axes`, the reference's tree) a rank holds its
rows of the batch and the loss is the mean over the global batch
(`collectives.batch_mean`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from cloudtik_tpu_torch.device import DeviceLike, resolve_device
from cloudtik_tpu_torch.ops.transducer import transducer_loss
from cloudtik_tpu_torch.parallel import collectives

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class RNNTConfig:
    vocab_size: int = 29             # chars + blank(0), librispeech-style
    feature_dim: int = 80            # log-mel bins
    enc_hidden: int = 1024
    enc_layers_pre: int = 2          # before time reduction
    enc_layers_post: int = 3         # after 2x time reduction
    time_reduction: int = 2
    pred_hidden: int = 512
    pred_layers: int = 2
    joint_dim: int = 512
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    def flops_per_frame(self) -> float:
        """fwd+bwd FLOPs per input frame (LSTM gates dominate; the
        reference's count, which leaves out the predictor and the
        joint)."""
        def lstm(d_in, h):
            return 2 * (d_in + h) * 4 * h
        f = 0.0
        d = self.feature_dim
        for _ in range(self.enc_layers_pre):
            f += lstm(d, self.enc_hidden)
            d = self.enc_hidden
        d *= self.time_reduction
        for _ in range(self.enc_layers_post):
            f += lstm(d, self.enc_hidden) / self.time_reduction
            d = self.enc_hidden
        return 3.0 * f


PRESETS: Dict[str, RNNTConfig] = {
    "rnnt": RNNTConfig(),
    "tiny": RNNTConfig(vocab_size=8, feature_dim=8, enc_hidden=16,
                       enc_layers_pre=1, enc_layers_post=1,
                       pred_hidden=16, pred_layers=1, joint_dim=16),
}


def config(name: str, **overrides) -> RNNTConfig:
    return dataclasses.replace(PRESETS[name], **overrides)


def num_params(cfg: RNNTConfig) -> int:
    """Parameters in the tree `init_params` makes."""
    def lstm(d_in, h):
        return (d_in + h) * 4 * h + 4 * h
    n, d = 0, cfg.feature_dim
    for _ in range(cfg.enc_layers_pre):
        n += lstm(d, cfg.enc_hidden)
        d = cfg.enc_hidden
    d *= cfg.time_reduction
    for _ in range(cfg.enc_layers_post):
        n += lstm(d, cfg.enc_hidden)
        d = cfg.enc_hidden
    n += cfg.pred_layers * lstm(cfg.pred_hidden, cfg.pred_hidden)
    n += cfg.vocab_size * cfg.pred_hidden
    n += (cfg.enc_hidden + cfg.pred_hidden) * cfg.joint_dim
    n += cfg.joint_dim * cfg.vocab_size + cfg.vocab_size
    return n


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def _lstm_axes() -> Params:
    return {"w": ("embed", "mlp"), "b": ("mlp",)}


def param_logical_axes(cfg: RNNTConfig) -> Params:
    """The reference's logical axes, leaf for leaf."""
    return {
        "encoder": [_lstm_axes() for _ in range(
            cfg.enc_layers_pre + cfg.enc_layers_post)],
        "predictor": {
            "embed": ("vocab", "embed"),
            "layers": [_lstm_axes() for _ in range(cfg.pred_layers)],
        },
        "joint": {
            "enc_proj": ("embed", "mlp"),
            "pred_proj": ("embed", "mlp"),
            "out": ("mlp", "vocab"),
            "out_bias": ("vocab",),
        },
    }


def init_params(generator: torch.Generator, cfg: RNNTConfig,
                device: DeviceLike = None) -> Params:
    """Same tree, shapes and dtypes as the JAX `init_params` (forget-gate
    bias 1.0); draws come from `generator` (on `device`), so they are
    not jax.random's."""
    dev = resolve_device(device)
    pdt = cfg.param_dtype

    def normal(shape, scale):
        w = torch.empty(shape, device=dev, dtype=torch.float32)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return (w * scale).to(pdt)

    def lstm(d_in, hidden):
        b = torch.zeros((4 * hidden,), device=dev, dtype=torch.float32)
        # forget-gate bias 1.0, so early training keeps the cell state
        b[hidden:2 * hidden] = 1.0
        return {"w": normal((d_in + hidden, 4 * hidden),
                            (d_in + hidden) ** -0.5),
                "b": b.to(pdt)}

    def dense(i, o):
        return normal((i, o), i ** -0.5)

    enc: List[Params] = []
    d = cfg.feature_dim
    for _ in range(cfg.enc_layers_pre):
        enc.append(lstm(d, cfg.enc_hidden))
        d = cfg.enc_hidden
    d *= cfg.time_reduction
    for _ in range(cfg.enc_layers_post):
        enc.append(lstm(d, cfg.enc_hidden))
        d = cfg.enc_hidden
    return {
        "encoder": enc,
        "predictor": {
            "embed": dense(cfg.vocab_size, cfg.pred_hidden),
            "layers": [lstm(cfg.pred_hidden, cfg.pred_hidden)
                       for _ in range(cfg.pred_layers)],
        },
        "joint": {
            "enc_proj": dense(cfg.enc_hidden, cfg.joint_dim),
            "pred_proj": dense(cfg.pred_hidden, cfg.joint_dim),
            "out": dense(cfg.joint_dim, cfg.vocab_size),
            "out_bias": torch.zeros((cfg.vocab_size,), device=dev,
                                    dtype=pdt),
        },
    }


# --------------------------------------------------------------------------
# LSTM
# --------------------------------------------------------------------------

def _lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
               w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused-gate step: x [B, D] in `dtype`, h and c [B, H] f32, w in
    `dtype`, b f32 -> the new (h, c) in f32."""
    zx = torch.cat([x, h.to(dtype)], dim=-1)
    gates = (zx @ w).float() + b
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def _lstm_layer(p: Params, xs: torch.Tensor, dtype) -> torch.Tensor:
    """xs [B, T, D] -> [B, T, H] in `dtype` (a loop over time, one fused
    product a step)."""
    B, T, _ = xs.shape
    H = p["b"].shape[0] // 4
    w = p["w"].to(dtype)
    b = p["b"].float()
    xs = xs.to(dtype)
    h = torch.zeros((B, H), dtype=torch.float32, device=xs.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(T):
        h, c = _lstm_cell(xs[:, t], h, c, w, b, dtype)
        hs.append(h.to(dtype))
    return torch.stack(hs, dim=1)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def encode(params: Params, features: torch.Tensor,
           cfg: RNNTConfig) -> torch.Tensor:
    """features [B, T, F] -> [B, T // reduction, H]."""
    x = features
    li = 0
    for _ in range(cfg.enc_layers_pre):
        x = _lstm_layer(params["encoder"][li], x, cfg.dtype)
        li += 1
    B, T, H = x.shape
    r = cfg.time_reduction
    x = x[:, :T - T % r].reshape(B, T // r, H * r)
    for _ in range(cfg.enc_layers_post):
        x = _lstm_layer(params["encoder"][li], x, cfg.dtype)
        li += 1
    return x


def predict(params: Params, labels: torch.Tensor,
            cfg: RNNTConfig) -> torch.Tensor:
    """labels [B, U] -> predictor states [B, U+1, H] (position 0 is the
    start-of-sequence state, as the transducer lattice expects)."""
    p = params["predictor"]
    B, U = labels.shape
    emb = p["embed"].to(cfg.dtype)
    x = emb[labels.long().clamp(0, emb.shape[0] - 1)]
    x = torch.cat([torch.zeros((B, 1, x.shape[-1]), dtype=x.dtype,
                               device=x.device), x], dim=1)
    for layer in p["layers"]:
        x = _lstm_layer(layer, x, cfg.dtype)
    return x


def joint(params: Params, enc: torch.Tensor, pred: torch.Tensor,
          cfg: RNNTConfig) -> torch.Tensor:
    """enc [B, T, He], pred [B, U+1, Hp] -> log probs [B, T, U+1, V]."""
    j = params["joint"]
    e = enc @ j["enc_proj"].to(cfg.dtype)
    g = pred @ j["pred_proj"].to(cfg.dtype)
    h = torch.tanh(e[:, :, None, :] + g[:, None, :, :]).to(cfg.dtype)
    logits = (h @ j["out"].to(cfg.dtype)).float() + j["out_bias"].float()
    return torch.log_softmax(logits, dim=-1)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: RNNTConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: features [B,T,F] f32, feature_lengths [B], labels [B,U]
    int (blank=0 padding), label_lengths [B] (this rank's rows on a
    mesh); the metrics detached."""
    enc = encode(params, batch["features"], cfg)
    pred = predict(params, batch["labels"], cfg)
    log_probs = joint(params, enc, pred, cfg)
    enc_lengths = torch.clamp(
        batch["feature_lengths"].long() // cfg.time_reduction, min=1)
    enc_lengths = torch.clamp(enc_lengths, 1, enc.shape[1])
    losses = transducer_loss(log_probs, batch["labels"], enc_lengths,
                             batch["label_lengths"])
    loss = collectives.batch_mean(losses)
    return loss, {"loss": loss.detach()}


@torch.no_grad()
def greedy_decode(params: Params, features: torch.Tensor, cfg: RNNTConfig,
                  max_symbols: int = 64) -> torch.Tensor:
    """Greedy transducer decode -> [B, max_symbols] int32 (0-padded): one
    symbol at most per encoder frame, the first frame scored against the
    start-of-sequence step pushed through the predictor stack."""
    enc = encode(params, features, cfg)
    p = params["predictor"]
    j = params["joint"]
    B, T, _ = enc.shape
    dt = cfg.dtype
    emb = p["embed"].to(dt)
    H = cfg.pred_hidden
    weights = [(layer["w"].to(dt), layer["b"].float())
               for layer in p["layers"]]

    def stack_step(x, states):
        new_states = []
        for (w, b), (h, c) in zip(weights, states):
            h, c = _lstm_cell(x, h, c, w, b, dt)
            new_states.append((h, c))
            x = h.to(dt)
        return x, new_states

    zeros = torch.zeros((B, H), dtype=torch.float32, device=enc.device)
    states = [(zeros, zeros) for _ in weights]
    # training's predict() feeds the zero SOS input through the stack for
    # the U=0 output; the decode starts from that output and its states
    g, states = stack_step(torch.zeros((B, emb.shape[-1]), dtype=dt,
                                       device=enc.device), states)
    enc_proj = j["enc_proj"].to(dt)
    pred_proj = j["pred_proj"].to(dt)
    out_w = j["out"].to(dt)
    out_b = j["out_bias"].float()
    out = torch.zeros((B, max_symbols), dtype=torch.int32,
                      device=enc.device)
    n = torch.zeros((B,), dtype=torch.int32, device=enc.device)
    slots = torch.arange(max_symbols, device=enc.device)[None, :]
    for t in range(T):
        h = torch.tanh(enc[:, t] @ enc_proj + g @ pred_proj).to(dt)
        logits = (h @ out_w).float() + out_b
        tok = logits.argmax(-1).to(torch.int32)
        emit = tok != 0
        new_g, new_states = stack_step(emb[tok.long()], states)
        g = torch.where(emit[:, None], new_g, g)
        states = [(torch.where(emit[:, None], hn, ho),
                   torch.where(emit[:, None], cn, co))
                  for (hn, cn), (ho, co) in zip(new_states, states)]
        pos = torch.clamp(n, 0, max_symbols - 1)
        write = emit & (n < max_symbols)
        out = torch.where((slots == pos[:, None]) & write[:, None],
                          tok[:, None], out)
        n = n + emit.to(torch.int32)
    return out
