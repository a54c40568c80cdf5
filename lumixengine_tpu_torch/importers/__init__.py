"""Importers for the reference engine's on-disk formats (counterpart of
``lumixengine_tpu/importers/``): the ``.unv`` world file and its writer,
``instantiate`` (a parsed scene into an Engine and a World), shipped
navmeshes (``.nav``), animation controllers (``.act``) and property
animations (``.anp``). Host code on numpy; each is the JAX package's
module with the port's imports. The FBX, ``.anm``, ``.mat``, ``.meta`` and
composite-texture codecs are not ported yet (ROADMAP Queue 1 item 7.4)."""
