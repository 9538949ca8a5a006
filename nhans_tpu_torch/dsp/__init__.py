"""Signal processing: STFT / iSTFT with tf.signal semantics, and the SNR
mixing of the training batch."""
