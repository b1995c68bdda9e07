"""Operations and bytes of the program's steps, from the configuration's
unpadded shapes."""
