"""Model families of the port: TAM/CTR-GCN (ST-GCN and the RGB models come
with later slices)."""
from .ctrgcn import CTRGC, CTRGCN, create_ctrgcn_nucla  # noqa: F401

_REGISTRY = {
    "ctrgcn": CTRGCN,
    # reference config compatibility (config/nucla/*.yaml model: keys)
    "models.ctrgcn.Model": CTRGCN,
}
_LATER = {
    "stgcn": "the ST-GCN slice",
    "models.stgcn.Model": "the ST-GCN slice",
    "resnet_only": "the RGB slice",
    "models.resnet_only.Model": "the RGB slice",
    "resnet_gcn_attention": "the RGB slice",
    "models.resnet_gcn_attention.ResNet_GCN_Attention": "the RGB slice",
}


def get_model(name: str, **model_args):
    """Instantiate a registered model by name. A `generator` keyword seeds
    the parameters; the compute dtype is float32 in this slice."""
    if name in _LATER:
        raise NotImplementedError(f"model {name!r} comes with {_LATER[name]}")
    dtype = model_args.pop("dtype", None)
    if dtype not in (None, "float32"):
        raise NotImplementedError(
            f"model dtype {dtype!r}: the port computes in float32 until the "
            "bf16 slice adds bfloat16"
        )
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    return cls(**model_args)
