"""Frame input (synthetic scenes, dataset PNG sequences through the native
loader, capture sources) and mesh / point-cloud export."""
