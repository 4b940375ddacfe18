from matrixone_tpu_torch.frontend.session import Result, Session

__all__ = ["Result", "Session"]
