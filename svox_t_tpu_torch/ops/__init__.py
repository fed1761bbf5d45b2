from .schedule import cost_order, ray_costs

__all__ = ["cost_order", "ray_costs"]
