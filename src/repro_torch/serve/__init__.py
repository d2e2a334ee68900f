from .engine import Request, Result, ServeEngine

__all__ = ["Request", "Result", "ServeEngine"]
