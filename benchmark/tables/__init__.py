"""Table packings, one module each, found by a traffic mix's
``route.tables`` name (``benchmark/tables/<tables>.py``). Each supplies:

  options() -> dict
      keyword options of the program's packers (``wide``, ``chunk_max``);
      a scene's loader passes those its packer takes
  finish(tables) -> tables
      what is done to each packed frame before it is rendered
"""
