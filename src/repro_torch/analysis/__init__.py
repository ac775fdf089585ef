"""Cost models: the analytic FLOPs and HBM-traffic model of the dry-run
(`roofline_model.py`)."""
