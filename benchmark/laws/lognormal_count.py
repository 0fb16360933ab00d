"""Dense features as heavy-tailed counts ``floor(exp(mu + sigma·N(0, 1)))``
passed through log(1 + x), as the DLRM scripts treat Criteo's counts.

Parameters: ``{"law": "lognormal_count", "mu": mu, "sigma": sigma}``."""
import torch


def values(gen: torch.Generator, shape: tuple, params: dict, device) -> torch.Tensor:
    """float32 values of ``shape``."""
    z = torch.randn(shape, generator=gen, device=device)
    return torch.log1p(torch.floor(torch.exp(params["mu"] + params["sigma"] * z)))
