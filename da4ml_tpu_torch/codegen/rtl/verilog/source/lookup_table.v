// ROM lookup (DAIS opcode 8): o = rom[a]. The .mem file is padded/rolled so
// the raw two's-complement bits of the key index directly (unreachable
// entries hold 'x'). rom_style hint lets synthesis pick LUTROM/BRAM.
module lookup_table #(
    parameter WA = 8,
    parameter WO = 8,
    parameter MEMFILE = "table.mem"
) (
    input  [WA-1:0] a,
    output [WO-1:0] o
);
    (* rom_style = "distributed" *) reg [WO-1:0] rom [0:(1 << WA)-1];
    initial $readmemh(MEMFILE, rom);
    assign o = rom[a];
endmodule
