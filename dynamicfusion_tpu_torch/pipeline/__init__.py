"""The per-frame pipeline (KinectFusion frame loop)."""
