"""Signal codec: chart widths and channels, the map-file writer and reader,
the hit, cursor and timing encoders, hit decoding, tempo inference, the .osu
serializer and the MAP slider fitter."""
