"""Signal processing: STFT / iSTFT with tf.signal semantics."""
