from .logutils import printlog

__all__ = ["printlog"]
