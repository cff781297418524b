"""Model families of the port: TAM/CTR-GCN and ST-GCN (the RGB models come
with later slices)."""
from .ctrgcn import CTRGC, CTRGCN, create_ctrgcn_nucla  # noqa: F401
from .stgcn import STGCN, create_stgcn_nucla, edge_importance_per_joint  # noqa: F401

_REGISTRY = {
    "ctrgcn": CTRGCN,
    # reference config compatibility (config/nucla/*.yaml model: keys)
    "models.ctrgcn.Model": CTRGCN,
    "stgcn": STGCN,
    "models.stgcn.Model": STGCN,
}
_LATER = {
    "resnet_only": "the RGB slice",
    "models.resnet_only.Model": "the RGB slice",
    "resnet_gcn_attention": "the RGB slice",
    "models.resnet_gcn_attention.ResNet_GCN_Attention": "the RGB slice",
}


def get_model(name: str, **model_args):
    """Instantiate a registered model by name. A `generator` keyword seeds
    the parameters; `dtype` (the config's model_args.dtype) is the compute
    dtype, float32 (None) or bfloat16 with float32 parameters, and any other
    raises."""
    if name in _LATER:
        raise NotImplementedError(f"model {name!r} comes with {_LATER[name]}")
    dtype = model_args.get("dtype")
    if dtype not in (None, "float32", "bfloat16"):
        raise NotImplementedError(
            f"model dtype {dtype!r}: the port computes in float32 or in "
            "bfloat16 (mixed precision, float32 parameters)"
        )
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown model {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    return cls(**model_args)
