from music_tpu_torch.cli import main

main()
