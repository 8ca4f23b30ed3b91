"""The native ``.bag`` training path: the host library ``csrc/bagio.cpp``
(`bagio`) and the batch loader built on it (`dataset.NativeTrainLoader`)."""
