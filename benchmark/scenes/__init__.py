"""Scenes, one module each, found by a configuration's ``scene`` name
(``benchmark/scenes/<scene>.py``). Each supplies:

  write_inputs(folder) -> str
      the input files that the program and the reference both read,
      written once into ``folder``; returns the folder the loaders take
  Program(cfg, tables, data_dir, device, rec)
      the program's loader (a ``tables`` module names the packing);
      ``.prepare(req)`` gives the device tables that request renders from
  reference(cfg, data_dir, device, lowp=None) -> frame(index)
      the plain reference's frame builder (``benchmark/reference``)
"""
