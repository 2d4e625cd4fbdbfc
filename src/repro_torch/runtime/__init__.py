from .serving import Completion, Request, ServingEngine

__all__ = ["Completion", "Request", "ServingEngine"]
