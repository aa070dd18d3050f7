"""The benchmark of ``tumseg_torch`` on one NVIDIA H100: facade-tile
serving and device-pipeline training of PointNet++ (see README.md)."""
