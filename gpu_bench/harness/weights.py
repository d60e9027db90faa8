"""Seeded CLIP weights and LoRA adapters, made on the device.

The tree has the layout the port loads (stacked transformer layers, ``(in,
out)`` kernels, the JAX package's names), in fp32, the type the port keeps
its master weights in. All leaves are views of one buffer drawn by one
``torch.randn`` call, each scaled to CLIP's initialisation: the same seed
gives the same weights, to the program and again to the reference. Biases
and LayerNorm parameters are drawn too (small), so that every term of a
layer reaches the output.
"""

from __future__ import annotations

import math

from gpu_bench.harness import seeds


def _blocks_spec(width: int, mlp: int, layers: int) -> dict:
    attn_std = width ** -0.5
    proj_std = attn_std * (2 * layers) ** -0.5
    fc_std = (2 * width) ** -0.5
    lin = lambda i, o, std: {"kernel": ((layers, i, o), std, 0.0), "bias": ((layers, o), 0.02, 0.0)}  # noqa: E731
    ln = {"scale": ((layers, width), 0.1, 1.0), "bias": ((layers, width), 0.02, 0.0)}
    return {
        "ln_1": dict(ln),
        "attn": {n: lin(width, width, proj_std if n == "out_proj" else attn_std)
                 for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
        "ln_2": dict(ln),
        "mlp": {"fc1": lin(width, mlp, fc_std), "fc2": lin(mlp, width, proj_std)},
    }


def clip_spec(w: dict) -> dict:
    """Leaf → (shape, std, mean) for the widths of a configuration file."""
    vw, tw, P = w["vision_width"], w["text_width"], w["projection_dim"]
    patch_dim = w["patch_size"] ** 2 * 3
    seq = (w["image_size"] // w["patch_size"]) ** 2 + 1
    ln = lambda d: {"scale": ((d,), 0.1, 1.0), "bias": ((d,), 0.02, 0.0)}  # noqa: E731
    return {
        "visual": {
            "patch_embed": {"kernel": ((patch_dim, vw), vw ** -0.5, 0.0)},
            "class_embedding": ((vw,), vw ** -0.5, 0.0),
            "pos_embedding": ((seq, vw), 0.01, 0.0),
            "ln_pre": ln(vw),
            "blocks": _blocks_spec(vw, w["vision_mlp_dim"], w["vision_layers"]),
            "ln_post": ln(vw),
            "proj": {"kernel": ((vw, P), vw ** -0.5, 0.0)},
        },
        "text": {
            "token_embedding": ((w["vocab_size"], tw), 0.02, 0.0),
            "pos_embedding": ((w["max_text_length"], tw), 0.01, 0.0),
            "blocks": _blocks_spec(tw, w["text_mlp_dim"], w["text_layers"]),
            "ln_final": ln(tw),
            "proj": {"kernel": ((tw, P), tw ** -0.5, 0.0)},
        },
    }


def lora_spec(w: dict, lora: dict) -> dict:
    """LoRA A (in, r) uniform in ±1/sqrt(in) as the port initialises it, B
    (r, out) normal with ``b_std`` (the port starts B at zero; a nonzero B
    makes the adapter change the output)."""
    r, spec = lora["r"], {}
    for tower, width, layers in (("visual", w["vision_width"], w["vision_layers"]),
                                 ("text", w["text_width"], w["text_layers"])):
        attn = {n: {"a": ((layers, width, r), "uniform", width ** -0.5),
                    "b": ((layers, r, width), lora["b_std"], 0.0)}
                for n in lora["target_modules"]}
        spec[tower] = {"blocks": {"attn": attn}}
    return spec


def _leaves(spec, path=()):
    if isinstance(spec, dict):
        for k in spec:
            yield from _leaves(spec[k], path + (k,))
    else:
        yield path, spec


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def materialise(spec: dict, seed: int, device, tag: str) -> dict:
    """One fp32 buffer from one generator call, cut into the spec's leaves
    and scaled in place."""
    import torch

    leaves = list(_leaves(spec))
    total = sum(math.prod(shape) for _, (shape, _, _) in leaves)
    g = seeds.device_generator(seed, device, tag)
    flat = torch.randn((total,), generator=g, device=device, dtype=torch.float32)
    tree: dict = {}
    at = 0
    for path, (shape, std, mean) in leaves:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if std == "uniform":
            # a normal draw mapped through its CDF is uniform in (0, 1)
            t.copy_(torch.special.ndtr(t).mul_(2).sub_(1).mul_(mean))
        else:
            t.mul_(std).add_(mean)
        _set(tree, path, t)
    return tree


def clip_weights(widths: dict, seed: int, device) -> dict:
    import torch

    tree = materialise(clip_spec(widths), seed, device, "clip")
    tree["logit_scale"] = torch.tensor(2.6592, dtype=torch.float32, device=device)
    return tree


def lora_weights(widths: dict, lora: dict, seed: int, device) -> dict:
    return materialise(lora_spec(widths, lora), seed, device, "lora")
