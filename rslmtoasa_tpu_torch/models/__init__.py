from .bulk import BulkSystem

__all__ = ["BulkSystem"]
