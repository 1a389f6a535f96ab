"""Signal codec: chart widths and channels, the map-file reader, hit
decoding, tempo inference, the .osu serializer and the MAP slider fitter."""
