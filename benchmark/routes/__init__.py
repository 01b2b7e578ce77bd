"""Routes into the renderer, one module each, found by a traffic mix's
``route.entry`` name (``benchmark/routes/<entry>.py``). Each supplies:

  render(cfg, tables, req, route, device) -> (colours, BGRA)
      the timed call: colours (H, W, 3) float32 and BGRA (H, W, 4) uint8
      on the host
  counter(route)
      the program's module whose ``launches`` / ``reset_launches`` count
      the path kernel that the route drives
"""
