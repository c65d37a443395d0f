"""The code that drives each kind of traffic mix, one file a kind (the ``entry`` key of
``traffic/<mix>.json``): ``index``, ``train``."""
