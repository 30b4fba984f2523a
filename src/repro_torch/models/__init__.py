from repro_torch.models.model import Model, trains_through_kernels

__all__ = ["Model", "trains_through_kernels"]
